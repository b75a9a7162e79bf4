"""Mesh engine parity (VERDICT r2 item 3): the hybrid gather+matmul count and
the sparse filter-then-verify path on the sharded scanner, validated on the
fake 8-device CPU mesh against the single-chip scanner and the host oracle."""

import random

import jax
import numpy as np
import pytest

import aho_corasick_1975_tpu as ac
from aho_corasick_1975_tpu.parallel.mesh import make_mesh
from aho_corasick_1975_tpu.parallel.sharded_scan import ShardedScanner


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    return make_mesh(8)


def _machine(seed=0, n=60):
    rng = random.Random(seed)
    m = ac.Machine()
    for _ in range(n):
        m.insert_keyword("".join(rng.choice("abcde")
                                 for _ in range(rng.randint(2, 7))))
    return m


def _oracle(m, text):
    cur = m.initiate()
    return sum(m.match(cur, ch) for ch in text)


def test_sharded_hybrid_count_parity(mesh8):
    m = _machine()
    rng = random.Random(1)
    text = "".join(rng.choice("abcdex") for _ in range(20000))
    single = m.scanner(n_streams=16, engine="gather")
    hyb = ShardedScanner(m, mesh8, n_streams_per_device=32, step_k=2,
                         engine="hybrid")
    assert hyb._hybrid is not None
    exp = _oracle(m, text)
    assert single.count(text) == exp
    assert hyb.count(text) == exp


def test_sharded_hybrid_session_and_refresh(mesh8):
    m = _machine(seed=2, n=30)
    rng = random.Random(3)
    text = "".join(rng.choice("abcdex") for _ in range(8000))
    hyb = ShardedScanner(m, mesh8, n_streams_per_device=32, step_k=2,
                         engine="hybrid")
    exp = _oracle(m, text)
    sess = hyb.session()
    got = sum(sess.feed_count(text[i:i + 331])
              for i in range(0, len(text), 331))
    assert got == exp
    m.insert_keyword("abcde")
    hyb.refresh()
    assert hyb.count(text) == _oracle(m, text)


def test_sharded_hybrid_tiny_stream_degenerates(mesh8):
    # per-device B < 16 -> pure stepped core path inside the same kernel
    m = _machine(seed=4, n=20)
    text = "abcde" * 40
    hyb = ShardedScanner(m, mesh8, n_streams_per_device=4, step_k=2,
                         engine="hybrid")
    assert hyb.count(text) == _oracle(m, text)


def test_sharded_sparse_count_parity(mesh8):
    m = _machine(seed=5)
    rng = random.Random(6)
    # low-density corpus: live islands in an OOV sea, some spanning
    # shard/block edges
    dead = "".join(rng.choice("XYZ ") for _ in range(1500))
    island = "".join(rng.choice("abcde") for _ in range(97))
    text = (dead + island) * 11
    sp = ShardedScanner(m, mesh8, n_streams_per_device=8, step_k=2,
                        prefilter="on")
    dense = ShardedScanner(m, mesh8, n_streams_per_device=8, step_k=2)
    exp = _oracle(m, text)
    assert dense.count(text) == exp
    assert sp.count(text) == exp
    assert sp.stats["sparse_live_frac"] < 0.5


def test_sharded_sparse_auto_declines_on_dense(mesh8):
    m = _machine(seed=7, n=30)
    rng = random.Random(8)
    text = "".join(rng.choice("abcde") for _ in range(6000))  # fully live
    sp = ShardedScanner(m, mesh8, n_streams_per_device=8, step_k=2,
                        prefilter="auto")
    assert sp.count(text) == _oracle(m, text)
    assert sp.stats["sparse_live_frac"] > 0.5  # filtered, then declined


def test_sharded_sparse_all_oov_short_circuits(mesh8):
    m = _machine(seed=9, n=10)
    sp = ShardedScanner(m, mesh8, n_streams_per_device=8, prefilter="on")
    assert sp.count("XYZ " * 5000) == 0


def test_sharded_sparse_session_carry(mesh8):
    m = _machine(seed=10, n=25)
    rng = random.Random(11)
    dead = "XYZ " * 400
    island = "".join(rng.choice("abcde") for _ in range(61))
    text = (island + dead) * 6 + island
    sp = ShardedScanner(m, mesh8, n_streams_per_device=8, step_k=2,
                        prefilter="on")
    exp = _oracle(m, text)
    sess = sp.session()
    got = sum(sess.feed_count(text[i:i + 777])
              for i in range(0, len(text), 777))
    assert got == exp


def test_sharded_sparse_dense_table_path(mesh8):
    # step_k=1 forces the dense (non-stepped) sparse core
    m = _machine(seed=12, n=25)
    rng = random.Random(13)
    text = ("QQQQ " * 300 + "".join(rng.choice("abcde")
                                    for _ in range(50))) * 7
    sp = ShardedScanner(m, mesh8, n_streams_per_device=8, step_k=1,
                        prefilter="on")
    assert sp._stepped is None
    assert sp.count(text) == _oracle(m, text)
