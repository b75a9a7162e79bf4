"""One-hot digit-matmul scan engine — lookups as int8 matrix products.

The automaton step next = delta[s, c] is a data-dependent lookup. For SMALL
automata it can be done as arithmetic instead:

    row[b, :]  = onehot(s_b) @ P          (int8 matmul)
    e[b]       = sum_v row[b, v] * onehot(c_b)[v]    (select-reduce)

where P stacks the packed table (next_state << count_bits | step_count)
as 7-bit digit planes, so every int8 x int8 -> int32 product is exact
(a one-hot row has exactly one nonzero; no accumulation overflow).

Measured on an NVIDIA H100 80GB HBM3 at a 400 W power limit (chip_smoke.py
phase 6, 64 MiB headline corpus, device-resident): at 184 states (256
padded) this engine takes 0.068 s per pass against the packed gather's
0.013 s, so ``engine="auto"`` never picks it on the GPU
(ops/autotune.auto_engine). It stays available as ``engine="mxu"``.

Reference anchor: this replaces the same hot loop as the gather kernels —
state_goto, aho_corasick.c:167-192.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

# Largest padded state count the engine accepts: its matmul work per
# symbol (2*S*planes*V) grows with S while a gather's cost does not.
MAX_MXU_STATES = 512

DIGIT_BITS = 7
DIGIT_MASK = (1 << DIGIT_BITS) - 1


def padded_states(n_states: int) -> int:
    """Row count of the digit planes for ``n_states`` states: growth
    headroom for online insertions, rounded up to a multiple of 128."""
    return max(128, -(-int(n_states * 9 / 8 + 1) // 128) * 128)


def build_planes(delta: np.ndarray, nb_outputs: np.ndarray,
                 max_states: Optional[int] = None
                 ) -> Optional[Tuple[np.ndarray, int, int, int]]:
    """Pack the dense tables into int8 digit planes for the MXU kernel.

    Returns (planes int8 [S_pad, n_planes*V], count_bits, n_planes, S_pad)
    or None when the automaton is too big for this engine (padded states
    over ``max_states`` — default MAX_MXU_STATES; the hybrid engine
    passes its own larger envelope — or the packed word would need > 4
    digits)."""
    S, V = delta.shape
    S_pad = padded_states(S)
    if S_pad > (max_states if max_states is not None else MAX_MXU_STATES):
        return None
    max_cnt = int(nb_outputs.max()) if S else 0
    count_bits = max(1, max_cnt.bit_length())
    # headroom for online insertions raising counts (mirrors multistep)
    count_bits = min(count_bits + 3, 28 - max(1, (S_pad - 1).bit_length()))
    if count_bits < max(1, max_cnt.bit_length()):
        return None
    state_bits = max(1, (S_pad - 1).bit_length())
    total_bits = state_bits + count_bits
    n_planes = -(-total_bits // DIGIT_BITS)
    if n_planes > 4:
        return None
    packed = ((delta.astype(np.int64) << count_bits)
              | nb_outputs[delta].astype(np.int64)).astype(np.int32)
    planes = np.zeros((S_pad, n_planes * V), np.int8)
    for p in range(n_planes):
        planes[:S, p * V:(p + 1) * V] = \
            ((packed >> (DIGIT_BITS * p)) & DIGIT_MASK).astype(np.int8)
    return planes, count_bits, n_planes, S_pad


def mxu_count_core(V: int, S_pad: int, count_bits: int, n_planes: int,
                   halo: int, planes, win):
    """Shared scan body: win [halo+L, B] time-major symbol ids in, per-
    stream int32 totals [B] out. Rows t < halo are warm-up (counts
    suppressed) — same contract as scan_xla.blocked_count_core, usable
    both under jit and inside shard_map local functions."""
    mask = (1 << count_bits) - 1
    eyeS = jnp.arange(S_pad, dtype=jnp.int32)
    eyeV = jnp.arange(V, dtype=jnp.int32)
    s0 = win[0] * 0
    zero = win[0] * 0

    def step(carry, tc):
        t, c = tc
        s, tot = carry
        onehot = (s[:, None] == eyeS[None, :]).astype(jnp.int8)
        R = lax.dot_general(onehot, planes, (((1,), (0,)), ((), ())),
                            preferred_element_type=jnp.int32)
        oc = (c[:, None] == eyeV[None, :]).astype(jnp.int32)
        e = zero
        for p in range(n_planes):
            e = e + (jnp.sum(R[:, p * V:(p + 1) * V] * oc, axis=1)
                     << (DIGIT_BITS * p))
        cnt = jnp.where(t >= halo, e & mask, 0)
        return (e >> count_bits, tot + cnt), None

    ts = jnp.arange(win.shape[0], dtype=jnp.int32)
    (_, tot), _ = lax.scan(step, (s0, zero), (ts, win))
    return tot


@lru_cache(maxsize=None)
def make_mxu_count_stream(V: int, S_pad: int, count_bits: int,
                          n_planes: int, halo: int, B: int, L: int):
    """Stream-input count through the MXU engine: ext [halo + B*L] in,
    per-stream int32 totals [B] out (same contract as
    scan_xla.make_blocked_count_stream)."""
    from .scan_xla import window_layout

    @jax.jit
    def count(planes, ext):
        win = window_layout(ext, B, L, halo)        # [halo+L, B]
        return mxu_count_core(V, S_pad, count_bits, n_planes, halo,
                              planes, win)

    return count


@lru_cache(maxsize=None)
def make_mxu_count_raw(V: int, S_pad: int, count_bits: int,
                       n_planes: int, halo: int, B: int, L: int):
    """Raw-input MXU count (scan_xla.raw_window staging contract)."""
    from .scan_xla import raw_window

    @jax.jit
    def count(planes, lut, ext_raw, head_ids):
        win = raw_window(lut, ext_raw, head_ids, B, L, halo)
        return mxu_count_core(V, S_pad, count_bits, n_planes, halo,
                              planes, win)

    return count


@lru_cache(maxsize=None)
def make_mxu_count(V: int, S_pad: int, count_bits: int, n_planes: int):
    """Time-major batch count (the count_many shape): tm [L, B] in with
    every stream starting at the root (halo 0, OOV padding inert), per-
    stream totals [B] out."""

    @jax.jit
    def count(planes, tm):
        return mxu_count_core(V, S_pad, count_bits, n_planes, 0, planes, tm)

    return count


def _mxu_count_many_body(V, S_pad, count_bits, n_planes, halo, c, Lp,
                         planes, w):
    from .scan_xla import split_docs_layout
    if c > 1:
        B = w.shape[1]
        w = split_docs_layout(w, c, Lp, halo)
        per = mxu_count_core(V, S_pad, count_bits, n_planes, halo,
                             planes, w)
        return per.reshape(c, B).sum(axis=0)
    return mxu_count_core(V, S_pad, count_bits, n_planes, 0, planes, w)


@lru_cache(maxsize=None)
def make_mxu_count_many(V: int, S_pad: int, count_bits: int,
                        n_planes: int, halo: int, c: int, Lp: int,
                        raw: bool = False):
    """Batched count through the MXU engine (round 5): optional in-kernel
    LUT encode (``raw``) and per-document block splitting (``c > 1``,
    split_docs_layout) — see make_stepped_count_many."""

    if raw:
        @jax.jit
        def count(planes, lut, tm):
            return _mxu_count_many_body(V, S_pad, count_bits, n_planes,
                                        halo, c, Lp, planes,
                                        lut[tm.astype(jnp.int32)])
    else:
        @jax.jit
        def count(planes, tm):
            return _mxu_count_many_body(V, S_pad, count_bits, n_planes,
                                        halo, c, Lp, planes, tm)

    return count


@lru_cache(maxsize=None)
def make_mxu_count_halo(V: int, S_pad: int, count_bits: int, n_planes: int,
                        halo: int):
    """Time-major count with warm-up rows: tm [halo+L, B], counts at
    t < halo suppressed (the elided sparse-window shape,
    models/scanner._sparse_count_elided)."""

    @jax.jit
    def count(planes, tm):
        return mxu_count_core(V, S_pad, count_bits, n_planes, halo,
                              planes, tm)

    return count
