"""Concurrency semantics (reference N11, SURVEY.md §2a/§5).

The reference serializes inserts with a machine-wide mutex and leaves the
match path lock-free, advertising concurrent insert + scan in Meyer mode
(README.md:364, 266). Equivalent guarantees here:

* insertion is serialized by the backend lock (C++ std::mutex / Python RLock);
* the native host match path is LOCK-FREE, like the reference's: matchers
  read a published shadow of the automaton and never block on inserters
  (acx.cpp "lock-free reader primitives"; memory-ordering stress runs under
  ASan/TSan via `make -C aho_corasick_1975_tpu/native tsan-test`);
* the device path is race-free by construction: scanners pin immutable
  snapshots (tested in test_meyer_equivalence.py).
"""

import random
import threading

import pytest

import aho_corasick_1975_tpu as ac


@pytest.mark.parametrize("backend", ["native", "python"])
def test_parallel_inserts_are_serialized(backend):
    """Many threads inserting concurrently must build a consistent machine
    containing exactly the union of their keywords."""
    rng = random.Random(0)
    words = ["".join(rng.choice("abcd") for _ in range(rng.randint(1, 7)))
             for _ in range(400)]
    m = ac.Machine(backend=backend)

    def worker(chunk):
        for w in chunk:
            cur = m.initiate()
            for ch in w:
                m.insert_letter_of_keyword(cur, ch)
            m.insert_end_of_keyword(cur)

    threads = [threading.Thread(target=worker, args=(words[i::4],))
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    assert m.nb_keywords() == len(set(words))
    # the machine equals a serially built one
    m2 = ac.Machine(backend=backend)
    for w in sorted(set(words)):
        m2.insert_keyword(w)
    assert sorted(k.text() for k in m.keywords()) == \
        sorted(k.text() for k in m2.keywords())
    # fail tables agree (state ids differ by insertion order, so compare
    # behaviourally via a random scan)
    text = "".join(rng.choice("abcdx") for _ in range(2000))
    c1, c2 = m.initiate(), m2.initiate()
    for ch in text:
        assert m.match(c1, ch) == m2.match(c2, ch)


def test_concurrent_insert_and_match_meyer():
    """Meyer mode: a matcher streaming while another thread inserts must
    never crash or observe a broken automaton; every match it reports is
    valid for some prefix of the insertion sequence (monotone counts)."""
    m = ac.Machine(backend="native", incremental=True)
    for w in ["he", "she"]:
        m.insert_keyword(w)
    stop = threading.Event()
    errors = []

    def inserter():
        rng = random.Random(1)
        while not stop.is_set():
            m.insert_keyword("".join(rng.choice("hers")
                                     for _ in range(rng.randint(1, 5))))

    def matcher():
        rng = random.Random(2)
        try:
            cur = m.initiate()
            for _ in range(3000):
                n = m.match(cur, rng.choice("hers "))
                if n:
                    mt = m.get_match(cur, 0)  # must always be retrievable
                    assert mt.length >= 1
        except Exception as e:  # pragma: no cover
            errors.append(e)

    ti = threading.Thread(target=inserter)
    tm = threading.Thread(target=matcher)
    ti.start()
    tm.start()
    tm.join()
    stop.set()
    ti.join()
    assert not errors


def test_lockfree_bulk_match_is_monotone_under_insertion():
    """The lock-free guarantee, observably: match_bulk passes running
    concurrently with per-letter and bulk insertion always count at least
    every keyword registered before the stress began (the published-shadow
    monotonicity contract) and never more than the final dictionary."""
    import numpy as np

    m = ac.Machine(backend="native", incremental=True)
    rng = random.Random(3)
    for _ in range(100):
        m.insert_keyword("".join(rng.choice("abcd")
                                 for _ in range(rng.randint(2, 5))))
    text = "".join(rng.choice("abcd") for _ in range(40000))
    ids = m.vocab.lookup_many(text)
    _, before = m._b.match_bulk(0, ids)
    assert before > 0
    counts, errors = [], []

    def matcher():
        try:
            for _ in range(40):
                _, total = m._b.match_bulk(0, ids)
                counts.append(total)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=matcher) for _ in range(3)]
    for t in threads:
        t.start()
    # concurrent registration: per-letter, then one deferred bulk batch
    for _ in range(150):
        m.insert_keyword("".join(rng.choice("abcd")
                                 for _ in range(rng.randint(2, 6))))
    kws = np.array([[1 + rng.randrange(4) for _ in range(5)]
                    for _ in range(1500)], dtype=np.int32)
    m._b.insert_keywords_bulk(
        kws.reshape(-1), np.arange(1501, dtype=np.int64) * 5)
    for t in threads:
        t.join()
    assert not errors
    _, after = m._b.match_bulk(0, ids)
    assert after >= before
    assert all(before <= c <= after for c in counts)


def test_snapshot_scan_is_isolated_from_bulk_insert():
    """A device-path scanner is immune to concurrent bulk insertion (snapshot
    pinning): counts from a snapshot never change while a bulk runs."""
    m = ac.Machine(backend="native")
    m.insert_keyword("abc")
    sc = m.scanner(n_streams=4)
    text = "abcabcabc" * 50
    before = sc.count(text)

    done = threading.Event()

    def bulk():
        rng = random.Random(3)
        for _ in range(8):
            m.insert_keywords(["".join(rng.choice("abc") for _ in range(4))
                               for _ in range(500)])
        done.set()

    t = threading.Thread(target=bulk)
    t.start()
    while not done.is_set():
        assert sc.count(text) == before
    t.join()
    assert m.scanner(n_streams=4).count(text) >= before


def test_refresh_races_concurrent_vocab_growing_inserts():
    """Regression for the round-1 race: Machine.compile() read vocab.size
    and the builder's max_letter non-atomically, so an insert landing
    between the two reads made emit_tables raise "vocab_size smaller than
    largest letter id". 4 threads hammer vocab-growing insert_keyword
    against scanner.refresh()/machine.compile() in a tight loop; the
    machine lock must make every snapshot self-consistent."""
    m = ac.Machine(backend="native")
    m.insert_keyword("seed")
    sc = m.scanner(n_streams=4, step_k=1)
    stop = threading.Event()
    errors = []

    def inserter(tid):
        try:
            i = 0
            while not stop.is_set() and i < 400:
                # every keyword introduces brand-new letters, so vocab.size
                # moves on every insertion — the racing window
                m.insert_keyword([f"w{tid}", f"x{tid}_{i}"])
                i += 1
        except Exception as e:  # pragma: no cover
            errors.append(e)

    def refresher():
        try:
            for _ in range(40):
                sc.refresh()
                m.compile()
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=inserter, args=(t,)) for t in range(4)]
    tr = threading.Thread(target=refresher)
    for t in threads:
        t.start()
    tr.start()
    tr.join()
    stop.set()
    for t in threads:
        t.join()
    assert not errors, errors
    # quiesced: the refreshed scanner agrees with a freshly built one
    sc.refresh()
    fresh = m.scanner(n_streams=4, step_k=1)
    probe = ["w0", "x0_1", "w1", "x1_0", "seed", "w3", "x3_2"]
    assert sc.count(probe) == fresh.count(probe)
