"""Conformance coverage for the hybrid gather+MXU count engine and the
round-3 scanner hardening (ADVICE r2):

* engine="hybrid" built explicitly on the CPU test backend must agree with
  engine="gather" and the sequential host oracle (the engine previously
  shipped auto-selected with zero conformance coverage);
* the pre-dispatch int32 per-stream accumulator guard;
* ragged count_many length bucketing (one long outlier no longer pads the
  whole batch);
* concurrent scans on ONE scanner serialize on the dispatch lock and stay
  correct.
"""

import threading

import numpy as np
import pytest

import aho_corasick_1975_tpu as ac

TEXT = ("To ushers: he found his pencil, but she could not find hers. "
        "ushers rush in; she sells seashells; his hissing hush. ") * 40
KEYWORDS = ["he", "she", "his", "hers", "ushers", "hush", "sells",
            "seashells", "s", "hi", "shells", "ell"]


def _machine():
    m = ac.Machine()
    for kw in KEYWORDS:
        m.insert_keyword(kw)
    return m


def _oracle_count(m, text):
    cur = m.initiate()
    return sum(m.match(cur, ch) for ch in text)


def test_hybrid_matches_gather_and_oracle():
    m = _machine()
    hybrid = m.scanner(engine="hybrid", n_streams=64)
    gather = m.scanner(engine="gather", n_streams=64)
    assert hybrid._hybrid is not None  # really the hybrid engine
    expected = _oracle_count(m, TEXT)
    assert gather.count(TEXT) == expected
    assert hybrid.count(TEXT) == expected


def test_hybrid_session_carry_across_chunks():
    m = _machine()
    hybrid = m.scanner(engine="hybrid", n_streams=32)
    assert hybrid._hybrid is not None
    expected = _oracle_count(m, TEXT)
    sess = hybrid.session()
    # 7 is coprime to every keyword length: chunk edges split matches.
    got = sum(sess.feed_count(TEXT[i:i + 7]) for i in range(0, len(TEXT), 7))
    assert got == expected


def test_hybrid_refresh_stays_conformant():
    m = _machine()
    hybrid = m.scanner(engine="hybrid", n_streams=32)
    m.insert_keyword("pencil")
    assert hybrid.refresh() in (True, False)
    assert hybrid.count(TEXT) == _oracle_count(m, TEXT)


def test_hybrid_raises_when_oversize():
    from aho_corasick_1975_tpu.ops import scan_hybrid
    m = ac.Machine()
    rng = np.random.default_rng(0)
    # enough random keywords to exceed MAX_HYBRID_STATES padded states
    n_kw = scan_hybrid.MAX_HYBRID_STATES // 4
    for _ in range(n_kw):
        m.insert_keyword("".join(
            chr(97 + c) for c in rng.integers(0, 26, size=9)))
    assert m.n_states > scan_hybrid.MAX_HYBRID_STATES
    with pytest.raises(ValueError, match="hybrid"):
        m.scanner(engine="hybrid")


def test_overflow_guard_raises_before_dispatch():
    m = _machine()
    s = m.scanner(n_streams=4)
    s._snap.max_nb = 2 ** 28  # pretend a pathological automaton
    with pytest.raises(ValueError, match="int32 per-stream accumulator"):
        s.count(TEXT)


def test_count_many_ragged_bucketing_parity():
    m = _machine()
    s = m.scanner()
    docs = ["she hers", "", "h", TEXT, "ushers" * 3, TEXT[:97],
            "hush " * 400, "x" * 5000]  # one long outlier + empties
    got = s.count_many(docs)
    exp = np.asarray([_oracle_count(m, d) for d in docs], np.int64)
    assert np.array_equal(got, exp), (got, exp)
    # bucketing really splits the launches: lengths span multiple buckets
    lengths = np.asarray([max(len(d), 1) for d in docs], np.int64)
    buckets = {L for L, _ in s._length_buckets(lengths, 128 * max(
        s.step_k if s._mxu is None else 1, 1))}
    assert len(buckets) >= 2


def test_count_many_ragged_sharded_parity():
    import jax

    from aho_corasick_1975_tpu.parallel.mesh import make_mesh
    from aho_corasick_1975_tpu.parallel.sharded_scan import ShardedScanner
    if jax.device_count() < 4:
        pytest.skip("needs >= 4 devices")
    m = _machine()
    s = ShardedScanner(m, make_mesh(4), n_streams_per_device=4, step_k=2)
    docs = ["she hers", "", TEXT, "hush " * 300, "he"]
    got = s.count_many(docs)
    exp = np.asarray([_oracle_count(m, d) for d in docs], np.int64)
    assert np.array_equal(got, exp), (got, exp)


def test_concurrent_scans_on_one_scanner():
    m = _machine()
    s = m.scanner(n_streams=32)
    expected = _oracle_count(m, TEXT)
    results = []
    errs = []

    def work():
        try:
            for _ in range(5):
                results.append(s.count(TEXT))
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    assert results == [expected] * 20
