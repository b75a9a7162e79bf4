"""DenseScanner.refresh(): incremental device-table maintenance.

The reference registers keywords *during* scanning (README.md:352-356,
exercised at generic_test.c:214-232); our device consistency model pins each
scanner to a table snapshot. refresh() bridges snapshots by scattering only
the changed/affected rows into the capacity-padded device tables. Every test
here asserts the refreshed scanner is observationally identical to a freshly
constructed one (the strongest possible oracle: fresh construction is the
already-conformance-tested path).
"""

from __future__ import annotations

import numpy as np
import pytest

import aho_corasick_1975_tpu as ac
from aho_corasick_1975_tpu.ops import multistep as ms

TEXT = "To ushers: he found his pencil, but she could not find hers."


def fresh_like(m, **kw):
    kw.setdefault("n_streams", 4)
    kw.setdefault("step_k", 2)
    return m.scanner(**kw)


def assert_equiv(sc, m, text, **kw):
    fresh = fresh_like(m, **kw)
    assert sc.count(text) == fresh.count(text)
    assert np.array_equal(sc.scan_states(text), fresh.scan_states(text))
    a = [(ev.start, ev.end, ev.index, mt.rank, tuple(mt.letters))
         for ev, mt in sc.find_matches(text)]
    b = [(ev.start, ev.end, ev.index, mt.rank, tuple(mt.letters))
         for ev, mt in fresh.find_matches(text)]
    assert a == b
    return fresh


def test_refresh_in_place_equals_fresh():
    m = ac.Machine()
    for w in ["he", "she", "his", "hers"]:
        m.insert_keyword(w)
    sc = fresh_like(m)
    assert sc.count(TEXT) == 9
    cap, buf_shape = sc._cap, sc._st_dev[0].shape
    # same alphabet -> in-place path
    for w in ["is", "her", "hiss", "shes", "here"]:
        m.insert_keyword(w)
    assert sc.refresh() is True
    assert sc.version == m.version
    assert sc.stats["refresh_rows"] > 0
    # stable shapes: no reallocation, no recompile-forcing shape change
    assert sc._cap == cap and sc._st_dev[0].shape == buf_shape
    assert_equiv(sc, m, TEXT)


def test_refresh_noop_on_duplicate_insert():
    m = ac.Machine()
    m.insert_keyword("he")
    sc = fresh_like(m)
    before = sc._st_dev[0]
    m.insert_keyword("he")  # version bump, no table change
    assert sc.refresh() is True
    assert sc.version == m.version
    assert sc._st_dev[0] is before  # no scatter was issued
    assert sc.count("he he") == 2


def test_vocab_growth_falls_back_to_full_reload():
    m = ac.Machine()
    m.insert_keyword("he")
    sc = fresh_like(m)
    m.insert_keyword("ox")  # new letters -> wider tables
    assert sc.refresh() is False
    assert_equiv(sc, m, "an ox and he and hex")


def test_capacity_growth_falls_back_to_full_reload():
    m = ac.Machine()
    m.insert_keyword("ab")
    sc = fresh_like(m)
    assert sc._cap == 1024
    m.insert_keyword("ab" * 700)  # 1400 new states > capacity
    assert sc.refresh() is False
    assert sc._cap >= m.n_states
    assert sc.count("xx abab yy") == 2  # 'ab' twice, long keyword absent


def test_count_bits_headroom_absorbs_small_growth():
    m = ac.Machine()
    m.insert_keyword("ab")
    sc = fresh_like(m)
    assert sc._stepped is not None and sc._stepped.count_bits == 4
    m.insert_keyword("b")  # gram (a,b) now yields 2 matches: fits headroom
    assert sc.refresh() is True
    assert_equiv(sc, m, "ab b abab")


def test_count_bits_overflow_falls_back_to_full_reload():
    m = ac.Machine()
    m.insert_keyword("ab")
    sc = fresh_like(m)
    bits = sc._stepped.count_bits
    # pile suffix keywords onto one fail chain until a single-gram count
    # exceeds the packed width (nb_outputs of 'a'*15+'b' reaches 17)
    for j in [0] + list(range(2, 16)):
        m.insert_keyword("a" * j + "b")
    assert sc.refresh() is False
    assert sc._stepped.count_bits > bits
    assert_equiv(sc, m, "a" * 20 + "b" + " ab b")


def test_halo_growth_keeps_block_spanning_matches_exact():
    m = ac.Machine()
    for w in ["he", "she"]:
        m.insert_keyword(w)
    sc = fresh_like(m)
    assert sc.halo == 2
    long_kw = "hehehehehehehehehehe"  # depth 20 > old halo
    m.insert_keyword(long_kw)
    assert sc.refresh() is True
    assert sc.halo >= len(long_kw) - 1
    text = ("x" * 37 + long_kw + "y" * 23) * 40  # spans many tiny blocks
    fresh = assert_equiv(sc, m, text)
    # host-oracle count: the machine's own streaming match
    cur = m.initiate()
    host = sum(m.match_stream(cur, text[i:i + 97])
               for i in range(0, len(text), 97))
    assert sc.count(text) == host == fresh.count(text)


def test_refresh_fuzz_rounds_match_fresh_scanner():
    rng = np.random.default_rng(7)
    alphabet = "abcd"
    m = ac.Machine()
    m.insert_keyword(alphabet)  # pin the vocabulary
    sc = fresh_like(m)
    in_place = 0
    for _ in range(8):
        for _ in range(int(rng.integers(1, 6))):
            n = int(rng.integers(1, 7))
            w = "".join(rng.choice(list(alphabet), n))
            m.insert_keyword(w)
        in_place += bool(sc.refresh())  # False = legitimate fallback
        text = "".join(rng.choice(list(alphabet + " "), 400))
        fresh = fresh_like(m)
        assert sc.count(text) == fresh.count(text)
        assert np.array_equal(sc.scan_states(text), fresh.scan_states(text))
    assert in_place >= 6  # the incremental path carried most rounds


def test_refresh_unpacked_mode(monkeypatch):
    """Exercise the two-table refresh branch by forcing unpacked tables."""
    orig = ms.build_stepped

    def unpacked(tables, k, cap_rows=None):
        st = orig(tables, k)
        if st.packed is not None:
            cb = st.count_bits
            st.delta_k = (st.packed >> cb).astype(np.int32)
            st.cnt_k = (st.packed & ((1 << cb) - 1)).astype(np.int32)
            st.packed = None
            st.cap_packed = None
            st.count_bits = 0
        return st

    monkeypatch.setattr(ms, "build_stepped", unpacked)
    m = ac.Machine()
    for w in ["he", "she", "his", "hers"]:
        m.insert_keyword(w)
    sc = m.scanner(n_streams=4, step_k=2, step_budget_bytes=1 << 30)
    assert sc._stepped is not None and sc._stepped.packed is None
    for w in ["is", "her", "hiss"]:
        m.insert_keyword(w)
    assert sc.refresh() is True
    fresh = m.scanner(n_streams=4, step_k=2, step_budget_bytes=1 << 30)
    assert sc.count(TEXT) == fresh.count(TEXT)


def test_session_sees_refresh_from_next_chunk():
    m = ac.Machine()
    m.insert_keyword("he")
    m.insert_keyword("hse")  # pins the vocabulary; never occurs below
    sc = fresh_like(m)
    s = sc.session()
    assert s.feed_count("he she") == 2  # 'he' twice
    m.insert_keyword("she")
    assert sc.refresh() is True
    # new keyword counted from the next chunk on; old keywords still
    # matched across the chunk edge via the carried tail
    assert s.feed_count(" she h") == 2  # 'she' + inner 'he'
    assert s.feed_count("e") == 1       # 'he' spanning the chunk edge
    assert s.checkpoint()["version"] == m.version


def test_refresh_on_1char_path_without_stepped_tables():
    m = ac.Machine()
    for w in ["he", "she", "hers"]:
        m.insert_keyword(w)
    sc = m.scanner(n_streams=4, step_k=1)
    assert sc._stepped is None
    m.insert_keyword("hehe")  # existing letters only
    assert sc.refresh() is True
    assert_equiv(sc, m, TEXT + " hehe", step_k=1)


@pytest.mark.parametrize("k", [2, 3])
def test_stepped_delta_cells_reconstructs_new_table(k):
    """Applying the extracted cell deltas onto the old stepped table must
    reproduce the new one exactly (the invariant refresh() relies on)."""
    rng = np.random.default_rng(11)
    alphabet = "abc"
    m = ac.Machine()
    m.insert_keyword(alphabet)
    old = m.compile()
    for _ in range(25):
        n = int(rng.integers(1, 8))
        m.insert_keyword("".join(rng.choice(list(alphabet), n)))
    new = m.compile()
    cells, land, cnt = ms.stepped_delta_cells(old, new, k)

    S_new, V = new.delta.shape
    rows = np.arange(S_new, dtype=np.int64)
    d_old, c_old = ms.compose_rows(old.delta, old.nb_outputs,
                                   np.arange(old.n_states, dtype=np.int64), k)
    d_new, c_new = ms.compose_rows(new.delta, new.nb_outputs, rows, k)
    # start from the old table padded with garbage for the new rows
    d_app = np.full_like(d_new, -7)
    c_app = np.full_like(c_new, -7)
    d_app[:old.n_states] = d_old
    c_app[:old.n_states] = c_old
    d_app.reshape(-1)[cells] = land
    c_app.reshape(-1)[cells] = cnt
    np.testing.assert_array_equal(d_app, d_new)
    np.testing.assert_array_equal(c_app, c_new)
