"""The shared engine="auto" rule (ops/autotune.auto_engine) and the
binding both scanners use (ops/autotune.resolve_engine), with the backend
injected: the gather everywhere outside a measured envelope, explicit
engines obeyed or refused exactly as before."""

import random

import pytest

import aho_corasick_1975_tpu as ac
from aho_corasick_1975_tpu.ops import autotune, scan_hybrid, scan_mxu


def _machine(n, alpha, seed=0):
    rng = random.Random(seed)
    m = ac.Machine()
    for _ in range(n):
        m.insert_keyword("".join(rng.choice(alpha)
                                 for _ in range(rng.randint(3, 8))))
    return m


@pytest.mark.parametrize("backend", ["gpu", "cpu"])
@pytest.mark.parametrize("s_pad", [256, 4480, 1 << 17])
def test_auto_is_gather_outside_measured_envelope(backend, s_pad):
    # 256 and 4,480 padded states: the two sizes the H100 measured
    assert autotune.auto_engine(backend, s_pad, True) == "gather"
    assert autotune.auto_engine(backend, s_pad, False) == "gather"


def test_auto_follows_an_envelope(monkeypatch):
    monkeypatch.setitem(autotune.AUTO_ENVELOPES, "gpu",
                        {"mxu": 512, "hybrid": 8192})
    assert autotune.auto_engine("gpu", 256, True) == "mxu"
    assert autotune.auto_engine("gpu", 4480, True) == "hybrid"
    assert autotune.auto_engine("gpu", 4480, False) == "gather"
    assert autotune.auto_engine("gpu", 16384, True) == "gather"
    assert autotune.auto_engine("cpu", 256, True) == "gather"


def test_resolve_auto_binds_gather_on_gpu():
    m = _machine(20, "abc")
    sc = m.scanner(step_k=2)
    assert scan_mxu.padded_states(m.n_states) <= scan_mxu.MAX_MXU_STATES
    mxu, hybrid = autotune.resolve_engine("auto", sc.tables, sc._stepped,
                                          lambda a: a, backend="gpu")
    assert mxu is None and hybrid is None


def test_resolve_explicit_engines_obeyed_and_refused():
    small = _machine(20, "abc")
    sc = small.scanner(step_k=2)
    mxu, hybrid = autotune.resolve_engine("mxu", sc.tables, sc._stepped,
                                          lambda a: a, backend="gpu")
    assert mxu is not None and hybrid is None
    assert mxu[3] == scan_mxu.padded_states(small.n_states)
    mxu, hybrid = autotune.resolve_engine("hybrid", sc.tables, sc._stepped,
                                          lambda a: a, backend="gpu")
    assert mxu is None and hybrid is not None
    with pytest.raises(ValueError, match="hybrid"):
        autotune.resolve_engine("hybrid", sc.tables, None, lambda a: a,
                                backend="gpu")
    big = _machine(400, "abcdefghij", seed=1)
    assert scan_mxu.padded_states(big.n_states) > scan_mxu.MAX_MXU_STATES
    with pytest.raises(ValueError, match="MXU"):
        big.scanner(engine="mxu")
    # auto never raises where an engine does not fit
    assert big.scanner()._mxu is None
    assert scan_hybrid.MAX_HYBRID_STATES >= scan_mxu.MAX_MXU_STATES
