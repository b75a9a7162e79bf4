"""Vectorized Vocab.lookup_many fast paths (str / bytes / int arrays).

The reference resolves genericity per scan symbol via an ordered-map lookup
(aho_corasick.c:175); we resolve it once at encode time. Round 1 did that
with a per-sign Python loop; these tests pin the vectorized paths to the
loop's exact semantics, for arbitrary key functions, including dictionary
growth between encodes (LUT invalidation).
"""

import numpy as np
import pytest

from aho_corasick_1975_tpu.utils.vocab import OOV, Vocab


def _oracle(v: Vocab, signs):
    return [v._ids.get(v.key_fn(s), OOV) for s in signs]


def test_str_identity_matches_oracle():
    v = Vocab()
    for ch in "hers untied":
        v.register(ch)
    text = "To ushers: he found his pencil, but she could not find hers. é☃"
    got = v.lookup_many(text)
    assert isinstance(got, np.ndarray) and got.dtype == np.int32
    assert got.tolist() == _oracle(v, text)


def test_str_casefold_key_fn():
    v = Vocab(key_fn=str.casefold)
    for ch in "hers":
        v.register(ch)
    text = "HeRS xyz H"
    assert v.lookup_many(text).tolist() == _oracle(v, text)


def test_str_lut_invalidated_on_growth():
    v = Vocab()
    v.register("a")
    t1 = "abc"
    assert v.lookup_many(t1).tolist() == [1, OOV, OOV]
    v.register("b")  # previously-OOV codepoint becomes known
    assert v.lookup_many(t1).tolist() == [1, 2, OOV]


def test_bytes_path():
    v = Vocab()
    for b in b"he":
        v.register(b)
    data = b"hex\x00\xff"
    got = v.lookup_many(data)
    assert isinstance(got, np.ndarray)
    assert got.tolist() == _oracle(v, data)


def test_uint8_array_takes_byte_lut_path():
    """uint8 ndarrays ride the 256-entry byte LUT (the generic int path
    np.unique-SORTS the whole array — minutes at GB scale; found while
    benching the 1 GB two-process config). Exact for any key_fn."""
    v = Vocab(key_fn=lambda x: x % 10)
    for s in [3, 7]:
        v.register(s)
    arr = np.array([3, 13, 7, 5, 23, 107, 255, 0], dtype=np.uint8)
    got = v.lookup_many(arr)
    assert got.tolist() == _oracle(v, [int(x) for x in arr])
    # parity with the bytes path byte-for-byte
    assert got.tolist() == list(v.lookup_many(arr.tobytes()))


def test_int_array_path_with_key_fn():
    v = Vocab(key_fn=lambda x: x % 10)
    for s in [3, 7]:
        v.register(s)
    arr = np.array([3, 13, 7, 5, 23, 107], dtype=np.int64)
    got = v.lookup_many(arr)
    assert got.tolist() == _oracle(v, arr.tolist())


def test_int_list_path():
    v = Vocab()
    for s in [100, 200]:
        v.register(s)
    xs = [100, 5, 200, 100]
    assert list(v.lookup_many(xs)) == _oracle(v, xs)


def test_char_list_joins_to_str_path():
    v = Vocab()
    for ch in "ab":
        v.register(ch)
    xs = list("abca")
    got = v.lookup_many(xs)
    assert list(got) == _oracle(v, xs)


def test_multichar_sign_list_falls_back():
    v = Vocab()
    v.register("foo")
    v.register("b")
    xs = ["foo", "b", "nope"]
    got = v.lookup_many(xs)  # join length mismatch -> per-sign loop
    assert list(got) == [1, 2, OOV]


def test_empty_inputs():
    v = Vocab()
    assert list(v.lookup_many("")) == []
    assert list(v.lookup_many(b"")) == []
    assert list(v.lookup_many(np.zeros(0, np.int64))) == []
    assert list(v.lookup_many([])) == []


def test_encode_throughput_floor():
    """The str path must encode over 50e6 symbols per second on the host
    (VERDICT r1 #6)."""
    import time
    v = Vocab()
    for ch in "abcdefgh ":
        v.register(ch)
    text = "abcdefgh " * 400_000  # 3.6 MB
    v.lookup_many(text)  # warm the LUT
    t0 = time.perf_counter()
    v.lookup_many(text)
    dt = time.perf_counter() - t0
    assert len(text) / dt > 50e6, f"{len(text) / dt:.3g} symbols/s"
