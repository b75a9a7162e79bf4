"""Randomized oracle equivalence: host streaming vs dense device scan vs brute
force, in both algorithm modes.

The reference's implicit oracle is mode-equivalence (Meyer vs -DNMEYER_85
binaries produce byte-identical output, SURVEY.md §4); here that oracle is
explicit and extended with an independent brute-force matcher. Small
alphabets + short random keywords force dense fail-link structure and heavy
output-set collapse.
"""

import random

import numpy as np
import pytest

import aho_corasick_1975_tpu as ac


def brute_force_events(keywords, text):
    """Sorted (end_pos, keyword) occurrence list, overlapping included."""
    out = []
    for kw in set(keywords):
        k = len(kw)
        for i in range(len(text) - k + 1):
            if text[i:i + k] == kw:
                out.append((i + k - 1, kw))
    return sorted(out)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("incremental", [True, False],
                         ids=["meyer85", "ac75"])
def test_random_dictionary_equivalence(seed, incremental):
    rng = random.Random(seed)
    alphabet = "ab" if seed % 2 else "abc"
    keywords = ["".join(rng.choice(alphabet)
                        for _ in range(rng.randint(1, 6)))
                for _ in range(40)]
    text = "".join(rng.choice(alphabet + "x") for _ in range(400))

    m = ac.Machine(incremental=incremental)
    for kw in keywords:
        m.insert_keyword(kw)
    assert m.nb_keywords() == len(set(keywords))

    expected = brute_force_events(keywords, text)

    # Host streaming path (reference Algorithm 1 semantics).
    cur = m.initiate()
    got_stream = []
    for i, ch in enumerate(text):
        for j in range(m.match(cur, ch)):
            got_stream.append((i, m.get_match(cur, j).text()))
    assert sorted(got_stream) == expected

    # Dense scan: sequential and blocked must agree everywhere.
    scanner = m.scanner(n_streams=16)
    states_seq = scanner.scan_states_sequential(text)
    states_blk = scanner.scan_states(text)
    np.testing.assert_array_equal(states_seq, states_blk)

    got_dense = sorted((ev.end, match.text())
                       for ev, match in scanner.find_matches(text))
    assert got_dense == expected
    assert scanner.count(text) == len(expected)


@pytest.mark.parametrize("incremental", [True, False],
                         ids=["meyer85", "ac75"])
def test_suffix_chain_stress(incremental):
    """Nested-suffix keywords (a, aa, aaa, ...) exercise the deepest fail
    chains and the Meyer IF recursion."""
    m = ac.Machine(incremental=incremental)
    N = 12
    for k in range(1, N + 1):
        m.insert_keyword("a" * k)
    text = "a" * 50
    cur = m.initiate()
    total = sum(m.match(cur, ch) for ch in text)
    # position i (0-based) matches min(i+1, N) keywords
    expected = sum(min(i + 1, N) for i in range(len(text)))
    assert total == expected
    assert m.scanner(n_streams=4).count(text) == expected


def test_oov_symbols_route_to_root():
    """Unknown signs behave exactly like undefined transitions from the root
    (reference modification [3], README.md:347): the cursor resets and no
    match fires."""
    m = ac.Machine()
    m.insert_keyword("ab")
    cur = m.initiate()
    assert m.match(cur, "a") == 0
    assert m.match(cur, "#") == 0   # OOV: back to root
    assert m.match(cur, "b") == 0   # 'b' after root: no 'ab'
    assert m.match(cur, "a") == 0
    assert m.match(cur, "b") == 1
    scanner = m.scanner()
    assert scanner.count("a#b ab") == 1


def test_int32_array_passthrough_is_bounds_checked():
    """int32 ndarrays are pre-encoded ids by contract; out-of-range values
    (e.g. raw integer signs) must raise, not scan garbage (review finding)."""
    import numpy as np
    m = ac.Machine()
    m.insert_keyword([5, 6])          # integer signs -> ids 1,2
    sc = m.scanner(n_streams=2)
    assert sc.count([5, 6]) == 1      # list goes through vocab
    with pytest.raises(ValueError, match="pre-encoded letter ids"):
        sc.count(np.array([5, 6], np.int32))   # raw signs as ndarray
    ids = np.asarray(m.vocab.lookup_many([5, 6]), np.int32)
    assert sc.count(ids) == 1         # properly encoded passthrough


@pytest.mark.parametrize("max_hits", [64, 4096])
def test_device_hit_extraction_equals_full_decode(max_hits):
    """Bounded device-side hit extraction (ops/hits.py) must produce the
    identical event list as the full-states decode path."""
    import random as _r
    rng = _r.Random(21)
    m = ac.Machine()
    for _ in range(40):
        m.insert_keyword("".join(rng.choice("ab")
                                 for _ in range(rng.randint(1, 5))))
    text = "".join(rng.choice("abx") for _ in range(2000))
    sc = m.scanner(n_streams=8)
    full = [(ev, match.text()) for ev, match in sc.find_matches(text)]
    if len({ev.end for ev, _ in full}) > max_hits:
        with pytest.raises(ValueError, match="exceed max_hits"):
            sc.find_matches(text, max_hits=max_hits)
        return
    dev = [(ev, match.text())
           for ev, match in sc.find_matches(text, max_hits=max_hits)]
    assert dev == full


def test_device_hit_extraction_overflow_raises():
    m = ac.Machine()
    m.insert_keyword("a")
    sc = m.scanner(n_streams=4)
    with pytest.raises(ValueError, match="exceed max_hits"):
        sc.find_matches("a" * 500, max_hits=16)
