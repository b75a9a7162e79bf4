"""Hybrid gather+matmul count engine: both scan formulations in one scan.

Part of the stream columns is counted with the packed k-gram gather, the
rest with the digit-matmul formulation of ops/scan_mxu.py, inside ONE
``lax.scan`` body — on the premise that the matmul work can hide in the
gather's issue shadow. On an NVIDIA H100 80GB HBM3 at a 400 W power limit
(chip_smoke.py phase 6, 64 MiB headline corpus, device-resident) it does
not: 0.075 s per pass against the gather's 0.018 s at 3,889 states, and
0.052 s against 0.013 s at 184 states. ``engine="auto"`` therefore never
picks it on the GPU (ops/autotune.auto_engine); it stays available as
``engine="hybrid"``.

Both halves run the same automaton and suppress the same halo warm-up,
so the per-stream totals concatenate exactly like a single-engine launch.
Reference anchor: same hot loop as every other engine here — state_goto,
aho_corasick.c:167-192.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
from jax import lax

from .multistep import combine_grams
from .scan_mxu import DIGIT_BITS

# Largest padded state count the engine accepts (its matmul half grows
# linearly with S while the gather half is flat).
MAX_HYBRID_STATES = 8192

# MXU columns per gather column at S_pad ~ 4k, scaled inversely with S_pad.
MXU_FRACTION = 32


def mxu_cols(B: int, S_pad: int) -> int:
    """How many of B total stream columns to scan with digit matmuls:
    ~B/32 at S_pad≈4k, scaled down with automaton size; multiple of 8, at
    least 8, at most B/2."""
    b2 = B * 3968 // (MXU_FRACTION * max(S_pad, 1))
    return max(8, min(B // 2, b2 // 8 * 8))


def hybrid_count_core(V: int, k: int, Vk: int, count_bits_g: int,
                      halo_steps: int, S_pad: int, n_planes: int,
                      count_bits_m: int, B1: int,
                      packed, planes, win):
    """win [halo_sym + L, B1 + B2] time-major symbols; first B1 columns
    counted via the packed k-gram gather, the rest via MXU digit matmuls.
    Returns per-stream int32 totals [B1 + B2]."""
    win_g, win_m = win[:, :B1], win[:, B1:]
    grams = combine_grams(win_g, V, k)              # [Lk, B1]
    Lk = grams.shape[0]
    syms = win_m.reshape(Lk, k, win_m.shape[1])     # k symbols per step
    mask_g = (1 << count_bits_g) - 1
    mask_m = (1 << count_bits_m) - 1
    eyeS = jnp.arange(S_pad, dtype=jnp.int32)
    eyeV = jnp.arange(V, dtype=jnp.int32)
    s0g = grams[0] * 0
    s0m = win_m[0] * 0

    def step(carry, x):
        sg, totg, sm, totm = carry
        t, g, sy = x
        live = t >= halo_steps
        e = packed[sg * Vk + g]
        totg = totg + jnp.where(live, e & mask_g, 0)
        for j in range(k):
            onehot = (sm[:, None] == eyeS[None, :]).astype(jnp.int8)
            R = lax.dot_general(onehot, planes, (((1,), (0,)), ((), ())),
                                preferred_element_type=jnp.int32)
            oc = (sy[j][:, None] == eyeV[None, :]).astype(jnp.int32)
            em = s0m * 0
            for p in range(n_planes):
                em = em + (jnp.sum(R[:, p * V:(p + 1) * V] * oc, axis=1)
                           << (DIGIT_BITS * p))
            totm = totm + jnp.where(live, em & mask_m, 0)
            sm = em >> count_bits_m
        return (e >> count_bits_g, totg, sm, totm), None

    ts = jnp.arange(Lk, dtype=jnp.int32)
    (_, totg, _, totm), _ = lax.scan(step, (s0g, s0g * 0, s0m, s0m * 0),
                                     (ts, grams, syms))
    return jnp.concatenate([totg, totm])


@lru_cache(maxsize=None)
def make_hybrid_count_stream(V: int, k: int, Vk: int, count_bits_g: int,
                             halo_steps: int, S_pad: int, n_planes: int,
                             count_bits_m: int, B1: int, B2: int, L: int):
    """Stream-input hybrid count: ext [halo_steps*k + (B1+B2)*L] in (same
    staging contract as the other *_stream kernels), totals [B1+B2] out."""
    from .scan_xla import window_layout

    @jax.jit
    def count(packed, planes, ext):
        win = window_layout(ext, B1 + B2, L, halo_steps * k)
        return hybrid_count_core(V, k, Vk, count_bits_g, halo_steps,
                                 S_pad, n_planes, count_bits_m, B1,
                                 packed, planes, win)

    return count


@lru_cache(maxsize=None)
def make_hybrid_count_raw(V: int, k: int, Vk: int, count_bits_g: int,
                          halo_steps: int, S_pad: int, n_planes: int,
                          count_bits_m: int, B1: int, B2: int, L: int):
    """Raw-input hybrid count (scan_xla.raw_window staging contract)."""
    from .scan_xla import raw_window

    @jax.jit
    def count(packed, planes, lut, ext_raw, head_ids):
        win = raw_window(lut, ext_raw, head_ids, B1 + B2, L,
                         halo_steps * k)
        return hybrid_count_core(V, k, Vk, count_bits_g, halo_steps,
                                 S_pad, n_planes, count_bits_m, B1,
                                 packed, planes, win)

    return count
