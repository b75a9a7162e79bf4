"""Meyer-1985 incremental maintenance == AC75 full reconstruction.

The reference's two compile-time variants must produce identical automata
(SURVEY.md §4 "mode-equivalence"; BASELINE north-star "incremental must equal
full reconstruction"). Because state ids are creation-order UIDs and both
modes build the identical goto trie, every emitted table must match
*exactly* — fail links, output counts, collapsed transitions, emit CSR.
"""

import random

import numpy as np
import pytest

import aho_corasick_1975_tpu as ac


def assert_tables_equal(ta, tb):
    np.testing.assert_array_equal(ta.delta, tb.delta)
    np.testing.assert_array_equal(ta.fail, tb.fail)
    np.testing.assert_array_equal(ta.nb_outputs, tb.nb_outputs)
    np.testing.assert_array_equal(ta.emit_start, tb.emit_start)
    np.testing.assert_array_equal(ta.emit_state, tb.emit_state)
    np.testing.assert_array_equal(ta.depth, tb.depth)
    np.testing.assert_array_equal(ta.is_end, tb.is_end)
    np.testing.assert_array_equal(ta.kw_rank, tb.kw_rank)


@pytest.mark.parametrize("seed", range(5))
def test_incremental_equals_rebuild(seed):
    rng = random.Random(100 + seed)
    alphabet = "abcd"
    keywords = ["".join(rng.choice(alphabet)
                        for _ in range(rng.randint(1, 8)))
                for _ in range(120)]
    meyer = ac.Machine(incremental=True)
    ac75 = ac.Machine(incremental=False)
    for kw in keywords:
        meyer.insert_keyword(kw)
        ac75.insert_keyword(kw)
    assert_tables_equal(meyer.compile(), ac75.compile())


def test_incremental_across_snapshots():
    """Insert / snapshot / insert again: the Meyer tables after online
    insertion must equal a from-scratch AC75 rebuild at every snapshot
    (the reference's insert-during-scan oracle, README.md:352-356)."""
    rng = random.Random(7)
    alphabet = "ab"
    meyer = ac.Machine(incremental=True)
    ac75 = ac.Machine(incremental=False)
    for round_ in range(4):
        for _ in range(30):
            kw = "".join(rng.choice(alphabet)
                         for _ in range(rng.randint(1, 7)))
            meyer.insert_keyword(kw)
            ac75.insert_keyword(kw)
        assert_tables_equal(meyer.compile(), ac75.compile())


def test_new_keywords_affect_next_snapshot_only():
    """Snapshot (scanner) pinning: a scanner built before an insertion keeps
    matching the old dictionary; a new scanner sees the addition — the device
    consistency model for incremental registration during scan."""
    m = ac.Machine(incremental=True)
    m.insert_keyword("he")
    s1 = m.scanner()
    assert s1.count("he she") == 2
    m.insert_keyword("she")
    assert s1.count("he she") == 2          # pinned snapshot
    s2 = m.scanner()
    assert s2.count("he she") == 3          # sees "she"
    assert s2.version > s1.version
