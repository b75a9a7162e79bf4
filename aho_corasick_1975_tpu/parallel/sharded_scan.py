"""Multi-chip data-parallel scanning: shard_map + ppermute halo + psum.

The corpus is sharded along the "data" mesh axis; the automaton tables are
replicated on every chip (they are small relative to HBM: a 10k-keyword
machine is a few MB of int32). A match can span a shard edge, so each shard
receives the last ``halo`` symbols of its left neighbor via ``lax.ppermute``
(shard 0 receives zeros = OOV, exactly the stream head), re-runs them from
the root as warm-up (convergence proof in ops/blocking.py), then scans its
own symbols with the same blocked kernel used single-chip. Per-stream int32
totals are combined with ``all_gather`` and summed on the host in int64 (a
two-level reduction: no 2^31 mesh-wide cap). XLA hands the collectives to
NCCL on GPUs — the communication backend the reference never had
(SURVEY.md §2c, §5 "Distributed communication backend").

Works unchanged on a multi-host mesh: shard_map + NamedSharding place the
collectives; nothing here is host-count-aware.
"""

from __future__ import annotations

import threading
from functools import lru_cache
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.snapshot import DeviceSnapshot
from ..ops import multistep as ms
from ..ops.scan_xla import blocked_count_core, window_layout
from .mesh import DATA_AXIS


def _right_shift_halo(ids_local, halo: int, axis_name: str, n_dev: int,
                      head=None):
    """Each shard sends its last ``halo`` symbols to its right neighbor.
    Shard 0 receives ``head`` (the session carry — the tail of the previous
    chunk, replicated) or zeros (OOV pad — correct for the stream head).

    Requires shard length >= halo (enforced by ShardedScanner padding) so
    one neighbor's tail always covers the warm-up; a shorter tail is
    OOV-padded at its head (only reachable for degenerate tiny streams)."""
    if halo == 0:
        return ids_local[:0]
    tail = ids_local[-halo:]
    if tail.shape[0] < halo:
        tail = jnp.concatenate(
            [jnp.zeros((halo - tail.shape[0],), tail.dtype), tail])
    if n_dev == 1:
        left = jnp.zeros_like(tail)
    else:
        # ppermute: devices missing as a destination receive zeros.
        left = lax.ppermute(tail, axis_name,
                            perm=[(i, i + 1) for i in range(n_dev - 1)])
    if head is not None:
        is0 = (lax.axis_index(axis_name) == 0).astype(left.dtype)
        left = left + head.reshape(-1) * is0
    return left


@lru_cache(maxsize=None)
def make_sharded_count(mesh: Mesh, V: int, halo: int,
                       n_streams_per_device: int = 256,
                       axis_name: str = DATA_AXIS, raw: bool = False):
    """Returns jitted count(dflat, nb_out, ids[, lut]) -> per-stream totals
    [n_dev, B] int32, replicated (all_gather).

    ids: int32 [T] with T divisible by the mesh size (caller pads with OOV;
    OOV lands on the root whose output count is 0, so padding is inert).
    dflat/nb_out replicated, ids sharded along ``axis_name``.

    ``raw``: ids are RAW symbols (uint8 bytes / int32 codepoints) and the
    replicated ``lut`` maps them to letter ids INSIDE the kernel — the
    mesh-wide device-side encode (raw 0 must behave like OOV, the
    models/scanner.raw_lut_entry contract), with the halo handoff riding
    the encoded stream so session heads stay in id space.

    Two-level reduction: int32 per-stream accumulators on device (a single
    stream holds < 2^31 matches), int64 grand total on the host — so a
    sharded count has the same overflow bound as the single-chip path
    instead of saturating at 2^31 across the whole mesh.
    """
    n_dev = mesh.shape[axis_name]

    def local_count(dflat, nb_out, lut, head, ids_local):
        ids_local = ids_local.reshape(-1)  # shard_map keeps rank; [T/D]
        if raw:
            ids_local = lut[ids_local.astype(jnp.int32)]
        Tl = ids_local.shape[0]
        left = _right_shift_halo(ids_local, halo, axis_name, n_dev, head)
        B = min(n_streams_per_device, max(1, Tl // 64))
        L = -(-Tl // B)
        pad = B * L - Tl
        ext = jnp.concatenate(
            [left, ids_local, jnp.zeros((pad,), ids_local.dtype)])
        win = window_layout(ext, B, L, halo)
        tot = blocked_count_core(V, halo, dflat, nb_out, win)  # [B] int32
        return lax.all_gather(tot, axis_name)

    # check_vma off: the all_gather output is replicated by construction,
    # but the static varying-axis checker cannot prove it.
    inner = jax.jit(jax.shard_map(
        local_count, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(axis_name)),
        out_specs=P(), check_vma=False))

    def fn(dflat, nb_out, ids, head=None, lut=None):
        if head is None:
            head = np.zeros(halo, np.int32)
        if lut is None:
            lut = np.zeros(1, np.int32)  # unused placeholder (raw=False)
        return inner(dflat, nb_out, lut, head, ids)

    return fn


@lru_cache(maxsize=None)
def make_sharded_stepped_count(mesh: Mesh, V: int, k: int, Vk: int,
                               count_bits: int, halo_steps: int,
                               n_streams_per_device: int = 256,
                               axis_name: str = DATA_AXIS,
                               raw: bool = False):
    """k-gram packed count over the mesh (the fast count path, sharded).
    Table replicated; corpus sharded; halo = halo_steps*k symbols.
    ``raw``: device-side encode via the replicated lut (see
    make_sharded_count). Returns per-stream totals [n_dev, B] int32
    (all_gather); callers sum on the host in int64 (same two-level
    reduction as make_sharded_count)."""
    n_dev = mesh.shape[axis_name]
    halo_sym = halo_steps * k

    def local_count(packed, lut, head, ids_local):
        ids_local = ids_local.reshape(-1)
        if raw:
            ids_local = lut[ids_local.astype(jnp.int32)]
        Tl = ids_local.shape[0]
        left = _right_shift_halo(ids_local, halo_sym, axis_name, n_dev, head)
        unit = 64 * k
        B = min(n_streams_per_device, max(1, Tl // unit))
        L = -(-(-(-Tl // B)) // unit) * unit
        pad = B * L - Tl
        ext = jnp.concatenate(
            [left, ids_local, jnp.zeros((pad,), ids_local.dtype)])
        win = window_layout(ext, B, L, halo_sym)
        tot = ms.stepped_count_core(V, k, Vk, count_bits, halo_steps,
                                    packed, win)           # [B] int32
        return lax.all_gather(tot, axis_name)

    inner = jax.jit(jax.shard_map(local_count, mesh=mesh,
                                  in_specs=(P(), P(), P(), P(axis_name)),
                                  out_specs=P(), check_vma=False))

    def fn(packed, ids, head=None, lut=None):
        if head is None:
            head = np.zeros(halo_sym, np.int32)
        if lut is None:
            lut = np.zeros(1, np.int32)
        return inner(packed, lut, head, ids)

    return fn


@lru_cache(maxsize=None)
def make_sharded_mxu_count(mesh: Mesh, V: int, S_pad: int, count_bits: int,
                           n_planes: int, halo: int,
                           n_streams_per_device: int = 256,
                           axis_name: str = DATA_AXIS, raw: bool = False):
    """Mesh-wide count through the MXU digit-matmul engine (small automata;
    ops/scan_mxu.py): planes replicated, corpus sharded, same ppermute halo
    handoff and two-level int32/int64 reduction as make_sharded_count.
    ``raw``: device-side encode via the replicated lut."""
    from ..ops.scan_mxu import mxu_count_core
    n_dev = mesh.shape[axis_name]

    def local_count(planes, lut, head, ids_local):
        ids_local = ids_local.reshape(-1)
        if raw:
            ids_local = lut[ids_local.astype(jnp.int32)]
        Tl = ids_local.shape[0]
        left = _right_shift_halo(ids_local, halo, axis_name, n_dev, head)
        B = min(n_streams_per_device, max(1, Tl // 64))
        L = -(-Tl // B)
        pad = B * L - Tl
        ext = jnp.concatenate(
            [left, ids_local, jnp.zeros((pad,), ids_local.dtype)])
        win = window_layout(ext, B, L, halo)
        tot = mxu_count_core(V, S_pad, count_bits, n_planes, halo,
                             planes, win)                   # [B] int32
        return lax.all_gather(tot, axis_name)

    inner = jax.jit(jax.shard_map(local_count, mesh=mesh,
                                  in_specs=(P(), P(), P(), P(axis_name)),
                                  out_specs=P(), check_vma=False))

    def fn(planes, ids, head=None, lut=None):
        if head is None:
            head = np.zeros(halo, np.int32)
        if lut is None:
            lut = np.zeros(1, np.int32)
        return inner(planes, lut, head, ids)

    return fn


@lru_cache(maxsize=None)
def make_sharded_hybrid_count(mesh: Mesh, V: int, k: int, Vk: int,
                              count_bits_g: int, halo_steps: int,
                              S_pad: int, n_planes: int, count_bits_m: int,
                              n_streams_per_device: int = 256,
                              axis_name: str = DATA_AXIS,
                              raw: bool = False):
    """Mesh-wide hybrid gather+matmul count (ops/scan_hybrid.py):
    packed table + digit planes replicated, corpus sharded, same ppermute
    halo handoff and two-level int32/int64 reduction as the other sharded
    counts. Tiny per-device streams (B < 16) degenerate to the pure
    stepped core — the MXU columns only pay off riding a wide gather.
    ``raw``: device-side encode via the replicated lut."""
    from ..ops import scan_hybrid
    n_dev = mesh.shape[axis_name]
    halo_sym = halo_steps * k

    def local_count(packed, planes, lut, head, ids_local):
        ids_local = ids_local.reshape(-1)
        if raw:
            ids_local = lut[ids_local.astype(jnp.int32)]
        Tl = ids_local.shape[0]
        left = _right_shift_halo(ids_local, halo_sym, axis_name, n_dev,
                                 head)
        unit = 64 * k
        B = min(n_streams_per_device, max(1, Tl // unit))
        L = -(-(-(-Tl // B)) // unit) * unit
        pad = B * L - Tl
        ext = jnp.concatenate(
            [left, ids_local, jnp.zeros((pad,), ids_local.dtype)])
        win = window_layout(ext, B, L, halo_sym)
        B2 = scan_hybrid.mxu_cols(B, S_pad) if B >= 16 else 0
        if B2 == 0:
            tot = ms.stepped_count_core(V, k, Vk, count_bits_g,
                                        halo_steps, packed, win)
        else:
            tot = scan_hybrid.hybrid_count_core(
                V, k, Vk, count_bits_g, halo_steps, S_pad, n_planes,
                count_bits_m, B - B2, packed, planes, win)
        return lax.all_gather(tot, axis_name)

    inner = jax.jit(jax.shard_map(
        local_count, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(axis_name)),
        out_specs=P(), check_vma=False))

    def fn(packed, planes, ids, head=None, lut=None):
        if head is None:
            head = np.zeros(halo_sym, np.int32)
        if lut is None:
            lut = np.zeros(1, np.int32)
        return inner(packed, planes, lut, head, ids)

    return fn


@lru_cache(maxsize=None)
def make_sharded_sparse_count(mesh: Mesh, V: int, k: int, Vk: int,
                              count_bits: int, halo_steps: int,
                              L_blk: int, nB_loc: int, cap: int,
                              use_stepped: bool,
                              axis_name: str = DATA_AXIS):
    """Mesh-wide filter-then-verify sparse count (ops/sparse.py, sharded):
    each shard gathers and scans ONLY its live L_blk-symbol blocks
    (host-filtered; pad slots point at the per-shard spare all-OOV block),
    with the cross-shard halo riding the same ppermute handoff — block 0's
    halo is the left neighbor's tail. Exact by the OOV-resets-to-root
    contract; per-window totals all_gather back for the int64 host sum."""
    from ..ops.sparse import _window_gather
    n_dev = mesh.shape[axis_name]
    halo = halo_steps * k if use_stepped else halo_steps

    def local_count(tab_a, tab_b, head, ids_local, idx_local):
        ids_local = ids_local.reshape(-1)
        idx_local = idx_local.reshape(-1)
        left = _right_shift_halo(ids_local, halo, axis_name, n_dev, head)
        ext = jnp.concatenate(
            [left, ids_local, jnp.zeros((L_blk,), ids_local.dtype)])
        win = _window_gather(ext, idx_local, nB_loc, L_blk, halo)
        if use_stepped:
            tot = ms.stepped_count_core(V, k, Vk, count_bits, halo_steps,
                                        tab_a, win)
        else:
            tot = blocked_count_core(V, halo, tab_a, tab_b, win)
        return lax.all_gather(tot, axis_name)

    inner = jax.jit(jax.shard_map(
        local_count, mesh=mesh,
        in_specs=(P(), P(), P(), P(axis_name), P(axis_name)),
        out_specs=P(), check_vma=False))

    def fn(tab_a, tab_b, ids, idx, head=None):
        if head is None:
            head = np.zeros(halo, np.int32)
        return inner(tab_a, tab_b, head, ids, idx)

    return fn


@lru_cache(maxsize=None)
def make_sharded_elided_count(mesh: Mesh, V: int, k: int, Vk: int,
                              count_bits: int, halo_steps: int,
                              use_stepped: bool,
                              axis_name: str = DATA_AXIS):
    """Mesh count over host-elided live windows (ops/sparse.elide_windows):
    tm [halo + L_blk, cap] time-major, the WINDOW axis sharded — windows
    are self-contained (each carries its own halo), so no ppermute is
    needed; per-window totals all_gather back for the int64 host sum.
    The mesh sibling of the single-chip elided path: wire bytes = live
    fraction x corpus, split across the mesh."""
    halo = halo_steps * k if use_stepped else halo_steps

    def local(tab_a, tab_b, tm):
        L = tm.shape[0]
        win = tm.reshape(L, -1)
        if use_stepped:
            tot = ms.stepped_count_core(V, k, Vk, count_bits, halo_steps,
                                        tab_a, win)
        else:
            tot = blocked_count_core(V, halo, tab_a, tab_b, win)
        return lax.all_gather(tot, axis_name)

    fn = jax.shard_map(local, mesh=mesh,
                       in_specs=(P(), P(), P(None, axis_name)),
                       out_specs=P(), check_vma=False)
    return jax.jit(fn)


@lru_cache(maxsize=None)
def make_sharded_elided_hits(mesh: Mesh, V: int, halo: int, L_blk: int,
                             max_hits_per_shard: int,
                             axis_name: str = DATA_AXIS):
    """Mesh bounded hits over host-elided live windows: tm
    [halo + L_blk, cap] and idx [cap] with the WINDOW axis sharded
    (windows are self-contained — no halo collective); positions are
    already absolute (idx holds global block ids). Buffers all_gather
    back replicated. The retrieval sibling of make_sharded_elided_count."""
    from ..ops.sparse import _window_hits_core

    def local(dflat, nb_out, tm, idx):
        # per-shard blocks arrive shaped [halo+L_blk, cap/n_dev] / [cap/n_dev]
        positions, sts, _, n_hit_pos = _window_hits_core(
            V, halo, L_blk, max_hits_per_shard, dflat, nb_out, tm, idx)
        return (lax.all_gather(positions, axis_name),
                lax.all_gather(sts, axis_name),
                lax.all_gather(n_hit_pos, axis_name))

    fn = jax.shard_map(local, mesh=mesh,
                       in_specs=(P(), P(), P(None, axis_name),
                                 P(axis_name)),
                       out_specs=(P(), P(), P()), check_vma=False)
    return jax.jit(fn)


@lru_cache(maxsize=None)
def make_sharded_count_many(mesh: Mesh, engine: str, consts: tuple,
                             halo: int, c: int, Lp: int, raw: bool,
                             axis_name: str = DATA_AXIS):
    """Shared sharded count_many factory (round 5): document axis
    sharded, optional in-kernel LUT encode (``raw``) and per-document
    block splitting (``c > 1`` — ops/scan_xla.split_docs_layout; the
    per-doc combine happens in-shard, so the all_gathered result keeps
    the [n_dev, B_local] convention). ``engine``: "dense" (consts =
    (V,)), "stepped" ((V, k, Vk, count_bits, halo_steps)), "mxu"
    ((V, S_pad, count_bits, n_planes, halo))."""
    from ..ops.multistep import _stepped_count_many_body
    from ..ops.scan_mxu import _mxu_count_many_body
    from ..ops.scan_xla import _count_many_body

    def body(tabs, w):
        if engine == "stepped":
            V_, k, Vk, cb, hs = consts
            return _stepped_count_many_body(V_, k, Vk, cb, hs, c, Lp,
                                            tabs[0], w)
        if engine == "mxu":
            V_, S_pad, cb, n_planes, h = consts
            return _mxu_count_many_body(V_, S_pad, cb, n_planes, h, c,
                                        Lp, tabs[0], w)
        (V_,) = consts
        return _count_many_body(V_, halo, c, Lp, tabs[0], tabs[1], w)

    n_tabs = 2 if engine == "dense" else 1

    def local(*args):
        *tabs_lut, tm = args
        tabs = tabs_lut[:n_tabs]
        L = tm.shape[0]
        w = tm.reshape(L, -1)
        if raw:
            w = tabs_lut[n_tabs][w.astype(jnp.int32)]
        return lax.all_gather(body(tabs, w), axis_name)

    n_in = n_tabs + (1 if raw else 0)
    fn = jax.shard_map(local, mesh=mesh,
                       in_specs=tuple([P()] * n_in) + (P(None, axis_name),),
                       out_specs=P(), check_vma=False)
    return jax.jit(fn)


@lru_cache(maxsize=None)
def make_sharded_scan_states(mesh: Mesh, V: int, halo: int,
                             n_streams_per_device: int = 256,
                             axis_name: str = DATA_AXIS):
    """Returns jitted scan(dflat, ids) -> states[T] (sharded like ids).

    Per-position automaton states across the whole sharded stream — the
    input to host-side match decoding (ops/decode.py) with per-shard
    offsets. Tail padding within each shard is the caller's concern (states
    at padded positions are root-reachable junk only if ids were padded
    mid-shard; pad only at the stream end)."""
    n_dev = mesh.shape[axis_name]

    def local_scan(dflat, head, ids_local):
        ids_local = ids_local.reshape(-1)
        Tl = ids_local.shape[0]
        left = _right_shift_halo(ids_local, halo, axis_name, n_dev, head)
        B = min(n_streams_per_device, max(1, Tl // 64))
        L = -(-Tl // B)
        pad = B * L - Tl
        ext = jnp.concatenate(
            [left, ids_local, jnp.zeros((pad,), ids_local.dtype)])
        win = window_layout(ext, B, L, halo)
        s0 = win[0] * 0  # varying-axis-safe zero init (see blocked_count_core)

        def step(s, c):
            s2 = dflat[s * V + c]
            return s2, s2

        _, states_tm = lax.scan(step, s0, win)       # [halo+L, B]
        body = states_tm[halo:, :]                   # drop warm-up
        return body.T.reshape(-1)[:Tl]

    inner = jax.jit(jax.shard_map(local_scan, mesh=mesh,
                                  in_specs=(P(), P(), P(axis_name)),
                                  out_specs=P(axis_name)))

    def fn(dflat, ids, head=None):
        if head is None:
            head = np.zeros(halo, np.int32)
        return inner(dflat, head, ids)

    return fn


@lru_cache(maxsize=None)
def make_sharded_hits(mesh: Mesh, V: int, halo: int, max_hits_per_shard: int,
                      n_streams_per_device: int = 256,
                      axis_name: str = DATA_AXIS):
    """Mesh-wide bounded match extraction: each shard scans locally, pulls
    its hit positions/states into a fixed-size buffer, and the buffers are
    combined with lax.all_gather — matches (positions + states) come back
    replicated without ever shipping the per-position state stream.

    Returns jitted hits(dflat, nb_out, ids) ->
      (positions [D, max], states [D, max], n_hit_positions [D]).
    Positions are absolute stream indices (-1 = empty slot)."""
    n_dev = mesh.shape[axis_name]

    def local_hits(dflat, nb_out, head, ids_local):
        ids_local = ids_local.reshape(-1)
        Tl = ids_local.shape[0]
        left = _right_shift_halo(ids_local, halo, axis_name, n_dev, head)
        B = min(n_streams_per_device, max(1, Tl // 64))
        L = -(-Tl // B)
        pad = B * L - Tl
        ext = jnp.concatenate(
            [left, ids_local, jnp.zeros((pad,), ids_local.dtype)])
        win = window_layout(ext, B, L, halo)
        s0 = win[0] * 0

        def step(s, c):
            s2 = dflat[s * V + c]
            return s2, s2

        _, states_tm = lax.scan(step, s0, win)
        body_states = states_tm[halo:, :]                  # [L, B]
        counts = nb_out[body_states]
        flat_states = body_states.T.reshape(-1)[:Tl]
        flat_counts = counts.T.reshape(-1)[:Tl]
        hit_mask = flat_counts > 0
        n_hit_pos = jnp.sum(hit_mask, dtype=jnp.int32)
        (idx,) = jnp.nonzero(hit_mask, size=max_hits_per_shard,
                             fill_value=-1)
        valid = idx >= 0
        shard_base = lax.axis_index(axis_name) * Tl
        positions = jnp.where(valid, idx + shard_base, -1)
        sts = jnp.where(valid, flat_states[jnp.maximum(idx, 0)], 0)
        return (lax.all_gather(positions, axis_name),
                lax.all_gather(sts, axis_name),
                lax.all_gather(n_hit_pos, axis_name))

    # check_vma off: the all_gather outputs are replicated by construction,
    # but the static varying-axis checker cannot prove it.
    inner = jax.jit(jax.shard_map(local_hits, mesh=mesh,
                                  in_specs=(P(), P(), P(), P(axis_name)),
                                  out_specs=(P(), P(), P()),
                                  check_vma=False))

    def fn(dflat, nb_out, ids, head=None):
        if head is None:
            head = np.zeros(halo, np.int32)
        return inner(dflat, nb_out, head, ids)

    return fn


@lru_cache(maxsize=None)
def make_sharded_stepped_hits(mesh: Mesh, V: int, k: int, Vk: int,
                              count_bits: int, halo_steps: int,
                              max_hits_per_shard: int,
                              n_streams_per_device: int = 256,
                              axis_name: str = DATA_AXIS):
    """Mesh-wide bounded hits at count-engine speed (the sharded sibling of
    ops/hits.make_stepped_hits_stream, VERDICT r3 #3): each shard runs the
    packed k-gram scan, refines only its live grams, and the bounded
    buffers all_gather back replicated with absolute stream positions.

    Returns jitted hits(packed, dflat, nb_out, ids[, head]) ->
      (positions [D, max], states [D, max], n_hit_pos [D], n_live [D]).
    Overflow contract per shard: n_live > max is truncation (n_hit_pos a
    lower bound), n_hit_pos > max is extraction overflow."""
    from ..ops.hits import stepped_hits_core
    n_dev = mesh.shape[axis_name]
    halo_sym = halo_steps * k

    def local_hits(packed, dflat, nb_out, head, ids_local):
        ids_local = ids_local.reshape(-1)
        Tl = ids_local.shape[0]
        left = _right_shift_halo(ids_local, halo_sym, axis_name, n_dev,
                                 head)
        B, L = _stepped_geometry(Tl, k, n_streams_per_device)
        pad = B * L - Tl
        ext = jnp.concatenate(
            [left, ids_local, jnp.zeros((pad,), ids_local.dtype)])
        win = window_layout(ext, B, L, halo_sym)
        positions, sts, _, n_hit_pos, n_live = stepped_hits_core(
            V, k, Vk, count_bits, halo_steps, max_hits_per_shard,
            packed, dflat, nb_out, ext, win)
        shard_base = lax.axis_index(axis_name) * Tl
        positions = jnp.where(positions >= 0, positions + shard_base, -1)
        return (lax.all_gather(positions, axis_name),
                lax.all_gather(sts, axis_name),
                lax.all_gather(n_hit_pos, axis_name),
                lax.all_gather(n_live, axis_name))

    inner = jax.jit(jax.shard_map(
        local_hits, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(axis_name)),
        out_specs=(P(), P(), P(), P()), check_vma=False))

    def fn(packed, dflat, nb_out, ids, head=None):
        if head is None:
            head = np.zeros(halo_sym, np.int32)
        return inner(packed, dflat, nb_out, head, ids)

    return fn


def _stepped_geometry(Tl: int, k: int, n_streams_per_device: int):
    """Per-shard blocked geometry for the stepped kernels — must agree
    between the hits scan and extract phases (both derive it from the
    static local length)."""
    unit = 64 * k
    B = min(n_streams_per_device, max(1, Tl // unit))
    L = -(-(-(-Tl // B)) // unit) * unit
    return B, L


@lru_cache(maxsize=None)
def make_sharded_stepped_hits_scan(mesh: Mesh, V: int, k: int, Vk: int,
                                   count_bits: int, halo_steps: int,
                                   n_streams_per_device: int = 256,
                                   axis_name: str = DATA_AXIS):
    """Phase A of SINGLE-PASS mesh auto retrieval (VERDICT r4 #2): each
    shard runs the packed k-gram count-speed scan ONCE, leaving its emit
    array device-resident and SHARDED; only the tiny per-shard counters
    all_gather back replicated. The caller syncs the counters, picks the
    pow2 cap/out buckets from the PER-SHARD maxima (not the global total
    — ADVICE r4: the old auto path sized every shard's buffer from the
    global count and could OOM on match-dense corpora), and feeds emit to
    the extract phase. One corpus pass total, vs the old count()+hits
    double scan.

    Returns jitted scan(packed, ids[, head]) ->
      (emit [D, halo_steps+Lk, B] sharded along axis 0,
       n_hits [D, B] replicated int32 per-stream (host sums in int64),
       n_live [D] replicated)."""
    from ..ops.hits import _stepped_emit_scan
    n_dev = mesh.shape[axis_name]
    halo_sym = halo_steps * k

    def local_scan(packed, head, ids_local):
        ids_local = ids_local.reshape(-1)
        Tl = ids_local.shape[0]
        left = _right_shift_halo(ids_local, halo_sym, axis_name, n_dev,
                                 head)
        B, L = _stepped_geometry(Tl, k, n_streams_per_device)
        pad = B * L - Tl
        ext = jnp.concatenate(
            [left, ids_local, jnp.zeros((pad,), ids_local.dtype)])
        win = window_layout(ext, B, L, halo_sym)
        emit, n_hits, n_live = _stepped_emit_scan(
            V, k, Vk, count_bits, halo_steps, packed, win)
        return (emit[None],                      # [1, halo_steps+Lk, B]
                lax.all_gather(n_hits, axis_name),
                lax.all_gather(n_live[None], axis_name))

    inner = jax.jit(jax.shard_map(
        local_scan, mesh=mesh,
        in_specs=(P(), P(), P(axis_name)),
        out_specs=(P(axis_name), P(), P()), check_vma=False))

    def fn(packed, ids, head=None):
        if head is None:
            head = np.zeros(halo_sym, np.int32)
        return inner(packed, head, ids)

    return fn


@lru_cache(maxsize=None)
def make_sharded_stepped_hits_extract(mesh: Mesh, V: int, k: int,
                                      count_bits: int, halo_steps: int,
                                      cap: int, out_size: int,
                                      n_streams_per_device: int = 256,
                                      axis_name: str = DATA_AXIS):
    """Phase B of single-pass mesh auto retrieval: refine each shard's
    live grams from the resident emit array (compiled at the pow2 ``cap``
    bucket of the actual per-shard live maximum; ``out_size`` from the
    per-shard exact match totals, so overflow is impossible in auto
    mode). Re-derives the halo'd local symbol stream with one ppermute —
    negligible next to the avoided second corpus scan.

    Returns jitted extract(dflat, nb_out, ids, emit[, head]) ->
      (positions [D, out_size] absolute (-1 pad), states [D, out_size]),
    both replicated."""
    from ..ops.hits import _hits_extract
    n_dev = mesh.shape[axis_name]
    halo_sym = halo_steps * k

    def local_extract(dflat, nb_out, head, ids_local, emit_local):
        ids_local = ids_local.reshape(-1)
        Tl = ids_local.shape[0]
        left = _right_shift_halo(ids_local, halo_sym, axis_name, n_dev,
                                 head)
        B, L = _stepped_geometry(Tl, k, n_streams_per_device)
        pad = B * L - Tl
        ext = jnp.concatenate(
            [left, ids_local, jnp.zeros((pad,), ids_local.dtype)])
        emit = emit_local.reshape(emit_local.shape[-2],
                                  emit_local.shape[-1])
        positions, sts, _ = _hits_extract(
            V, k, count_bits, halo_steps, cap, out_size, emit,
            lambda p: ext[halo_sym + p], dflat, nb_out)
        shard_base = lax.axis_index(axis_name) * Tl
        positions = jnp.where(positions >= 0, positions + shard_base, -1)
        return (lax.all_gather(positions, axis_name),
                lax.all_gather(sts, axis_name))

    inner = jax.jit(jax.shard_map(
        local_extract, mesh=mesh,
        in_specs=(P(), P(), P(), P(axis_name), P(axis_name)),
        out_specs=(P(), P()), check_vma=False))

    def fn(dflat, nb_out, ids, emit, head=None):
        if head is None:
            head = np.zeros(halo_sym, np.int32)
        return inner(dflat, nb_out, head, ids, emit)

    return fn


@lru_cache(maxsize=None)
def make_sharded_block_filter(mesh: Mesh, L_blk: int, nB_loc: int,
                              axis_name: str = DATA_AXIS):
    """Phase A of DEVICE-RESIDENT mesh sparse scanning (round 5): each
    shard runs the live-block filter on its own slice entirely on device
    (the mesh sibling of ops/sparse.make_block_filter). The order arrays
    stay sharded and device-resident; only the [D] live counts all_gather
    back replicated (one 4-byte-per-shard sync to pick the pow2 cap).

    Returns jitted filt(ids[, head]) ->
      (order [D, nB_loc] sharded, n_live [D] replicated)."""
    def local(ids_local):
        body = ids_local.reshape(-1).reshape(nB_loc, L_blk)
        live = body.max(axis=1) > 0
        n_live = jnp.sum(live, dtype=jnp.int32)
        order = jnp.argsort(jnp.logical_not(live),
                            stable=True).astype(jnp.int32)
        return order[None], lax.all_gather(n_live, axis_name)

    inner = jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(P(axis_name),),
        out_specs=(P(axis_name), P()), check_vma=False))

    # liveness is head-independent (the session head only seeds states)
    return lambda ids: inner(ids)


@lru_cache(maxsize=None)
def make_sharded_sparse_count_dev(mesh: Mesh, V: int, halo: int,
                                  L_blk: int, nB_loc: int, cap: int,
                                  axis_name: str = DATA_AXIS):
    """Device-resident mesh sparse COUNT (round 5): the counting sibling
    of make_sharded_sparse_hits_dev — each shard gathers only its live
    windows from its resident slice and counts them (dense-table core;
    per-window totals all_gather back [D, cap], host combines int64)."""
    from ..ops.sparse import _dev_idx, _window_gather
    n_dev = mesh.shape[axis_name]

    def local_count(dflat, nb_out, head, n_live_all, ids_local,
                    order_local):
        ids_local = ids_local.reshape(-1)
        left = _right_shift_halo(ids_local, halo, axis_name, n_dev, head)
        ext = jnp.concatenate(
            [left, ids_local, jnp.zeros((L_blk,), ids_local.dtype)])
        me = lax.axis_index(axis_name)
        idx = _dev_idx(order_local.reshape(-1), n_live_all[me], nB_loc,
                       cap)
        win = _window_gather(ext, idx, nB_loc, L_blk, halo)
        per = blocked_count_core(V, halo, dflat, nb_out, win)
        return lax.all_gather(per, axis_name)

    inner = jax.jit(jax.shard_map(
        local_count, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(axis_name), P(axis_name)),
        out_specs=P(), check_vma=False))

    def fn(dflat, nb_out, ids, order, n_live_all, head=None):
        if head is None:
            head = np.zeros(halo, np.int32)
        return inner(dflat, nb_out, head, n_live_all, ids, order)

    return fn


@lru_cache(maxsize=None)
def make_sharded_sparse_hits_dev(mesh: Mesh, V: int, halo: int, L_blk: int,
                                 nB_loc: int, cap: int, max_hits: int,
                                 axis_name: str = DATA_AXIS):
    """Phase B of device-resident mesh sparse retrieval (VERDICT r4 #3,
    mesh side): each shard gathers only its live windows from its
    RESIDENT corpus slice (halo via one ppermute) and extracts bounded
    hit positions/states; buffers all_gather back replicated with
    absolute stream positions. Zero per-call corpus upload.

    Returns jitted hits(dflat, nb_out, ids, order, n_live_all[, head]) ->
      (positions [D, max_hits], states [D, max_hits], n_hit_pos [D])."""
    from ..ops.sparse import _dev_idx, _window_gather, _window_hits_core
    n_dev = mesh.shape[axis_name]

    def local_hits(dflat, nb_out, head, n_live_all, ids_local,
                   order_local):
        ids_local = ids_local.reshape(-1)
        Tl = ids_local.shape[0]
        left = _right_shift_halo(ids_local, halo, axis_name, n_dev, head)
        ext = jnp.concatenate(
            [left, ids_local, jnp.zeros((L_blk,), ids_local.dtype)])
        me = lax.axis_index(axis_name)
        idx = _dev_idx(order_local.reshape(-1), n_live_all[me], nB_loc,
                       cap)
        win = _window_gather(ext, idx, nB_loc, L_blk, halo)
        positions, sts, _n_hits, n_hit_pos = _window_hits_core(
            V, halo, L_blk, max_hits, dflat, nb_out, win, idx)
        shard_base = me * Tl
        positions = jnp.where((positions >= 0) & (positions < Tl),
                              positions + shard_base, -1)
        return (lax.all_gather(positions, axis_name),
                lax.all_gather(sts, axis_name),
                lax.all_gather(n_hit_pos, axis_name))

    inner = jax.jit(jax.shard_map(
        local_hits, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(axis_name), P(axis_name)),
        out_specs=(P(), P(), P()), check_vma=False))

    def fn(dflat, nb_out, ids, order, n_live_all, head=None):
        if head is None:
            head = np.zeros(halo, np.int32)
        return inner(dflat, nb_out, head, n_live_all, ids, order)

    return fn


@lru_cache(maxsize=None)
def make_sharded_sparse_hits(mesh: Mesh, V: int, halo: int, L_blk: int,
                             nB_loc: int, cap: int,
                             max_hits_per_shard: int,
                             axis_name: str = DATA_AXIS):
    """Sharded filter-then-EXTRACT (the mesh sibling of
    ops/sparse.make_sparse_hits composed with make_sharded_hits): each
    shard scans only its live windows and pulls bounded hit positions/
    states, absolute across the sharded stream; buffers all_gather back
    replicated. Dense-table core (positions need per-symbol states)."""
    from ..ops.sparse import _window_gather
    n_dev = mesh.shape[axis_name]

    def local_hits(dflat, nb_out, head, ids_local, idx_local):
        ids_local = ids_local.reshape(-1)
        idx_local = idx_local.reshape(-1)
        Tl = ids_local.shape[0]
        left = _right_shift_halo(ids_local, halo, axis_name, n_dev, head)
        ext = jnp.concatenate(
            [left, ids_local, jnp.zeros((L_blk,), ids_local.dtype)])
        win = _window_gather(ext, idx_local, nB_loc, L_blk, halo)
        s0 = win[0] * 0

        def step(s, c):
            s2 = dflat[s * V + c]
            return s2, s2

        _, states_tm = lax.scan(step, s0, win)        # [halo+L_blk, cap]
        counts = nb_out[states_tm][halo:, :]          # [L_blk, cap]
        hit_mask = counts > 0
        n_hit_pos = jnp.sum(hit_mask, dtype=jnp.int32)
        shard_base = lax.axis_index(axis_name) * Tl
        pos2d = (idx_local[None, :] * L_blk
                 + jnp.arange(L_blk, dtype=jnp.int32)[:, None]
                 + shard_base)
        (flat_idx,) = jnp.nonzero(hit_mask.T.reshape(-1),
                                  size=max_hits_per_shard, fill_value=-1)
        valid = flat_idx >= 0
        safe = jnp.maximum(flat_idx, 0)
        positions = jnp.where(valid, pos2d.T.reshape(-1)[safe], -1)
        sts = jnp.where(valid,
                        states_tm[halo:, :].T.reshape(-1)[safe], 0)
        return (lax.all_gather(positions, axis_name),
                lax.all_gather(sts, axis_name),
                lax.all_gather(n_hit_pos, axis_name))

    inner = jax.jit(jax.shard_map(
        local_hits, mesh=mesh,
        in_specs=(P(), P(), P(), P(axis_name), P(axis_name)),
        out_specs=(P(), P(), P()), check_vma=False))

    def fn(dflat, nb_out, ids, idx, head=None):
        if head is None:
            head = np.zeros(halo, np.int32)
        return inner(dflat, nb_out, head, ids, idx)

    return fn


# Auto retrieval falls back to the full per-position decode only when the
# replicated hit buffers would BOTH exceed the decode's own footprint and
# this absolute floor (toy inputs stay on the fast path either way).
_AUTO_DECODE_FLOOR_BYTES = 64 << 20


class ShardedScanner:
    """Mesh-wide scanner over a machine snapshot: the multi-chip sibling of
    models.scanner.DenseScanner."""

    def __init__(self, machine, mesh: Mesh, n_streams_per_device: int = 256,
                 axis_name: str = DATA_AXIS, tables=None,
                 step_k: "int | str" = "auto",
                 step_budget_bytes: int = 128 * 1024 * 1024,
                 engine: str = "auto", prefilter: str = "off",
                 device_encode: bool = True,
                 device_encode_max_cp: int = 1024,
                 calibrate: bool = False):
        """``engine``: same contract as DenseScanner — "gather" (packed
        k-gram gather, default workhorse), "mxu" (one-hot digit-matmul
        count engine, small automata only, raises when oversize), "hybrid"
        (gather + digit matmuls in one scan, mid-size automata — raises
        when outside the ops/scan_hybrid.py envelope), "auto" (the same rule
        as DenseScanner: ops/autotune.auto_engine).

        ``prefilter``: "off" | "auto" | "on" — the filter-then-verify
        sparse count for low-match-density corpora (ops/sparse.py),
        sharded: the host bandwidth pass marks live blocks per shard and
        each device gathers/scans only its own live windows. Same
        exactness contract as DenseScanner(prefilter=...)."""
        if engine not in ("auto", "gather", "mxu", "hybrid"):
            raise ValueError(f"unknown engine {engine!r}")
        if prefilter not in ("off", "auto", "on"):
            raise ValueError(f"unknown prefilter {prefilter!r}")
        # Persistent XLA compile cache (round 5; utils/compile_cache.py,
        # opt-out ACX_COMPILE_CACHE=off).
        from ..utils.compile_cache import enable_compile_cache
        enable_compile_cache()
        self._engine = engine
        self._prefilter = prefilter
        self.machine = machine
        self.mesh = mesh
        self.axis_name = axis_name
        self.n_dev = mesh.shape[axis_name]
        repl = NamedSharding(mesh, P())
        self._repl = repl
        self._shard = NamedSharding(mesh, P(axis_name))
        # Replicated capacity-padded snapshot (same refresh machinery as
        # DenseScanner; the sharded kernels only take packed stepped tables).
        # np.asarray (not jnp): multi-process device_put needs an
        # uncommitted host value, identical on every process.
        self._snap = DeviceSnapshot(
            tables if tables is not None else machine.compile(),
            step_k=step_k, step_budget_bytes=step_budget_bytes,
            place=lambda a: jax.device_put(np.asarray(a), repl),
            packed_only=True)
        self.halo = max(self.tables.max_depth - 1, 0)
        self._n_streams_per_device = n_streams_per_device
        self._device_encode = device_encode
        self._device_encode_max_cp = device_encode_max_cp
        self._lut_cache: dict = {}
        self.stats: dict = {}
        # Dispatch lock (parity with DenseScanner, review r5): scans,
        # refresh() and recalibrate() serialize, so a kernel rebind can
        # never interleave with an in-flight scan's engine reads.
        self._dispatch = threading.RLock()
        self._bind_kernels()
        if calibrate and engine == "auto":
            self._calibrate_engine()

    def recalibrate(self) -> str:
        """Re-measure the engine choice on this mesh NOW (ignoring the
        cached choice) and rebind; returns the winner. Holds the dispatch
        lock, so in-flight scans on other threads finish before the
        rebind and later scans see the new engine — the same contract as
        DenseScanner.recalibrate (review r5: this was documented-unsafe
        while the single-chip sibling was locked)."""
        with self._dispatch:
            self._calibrate_engine(force=True)
            return self._engine

    def _calibrate_engine(self, force: bool = False) -> None:
        """Measured engine selection on the mesh (ops/autotune.py, the
        ShardedScanner sibling of DenseScanner._calibrate_engine): probe
        each available engine's production count() once over the sharded
        synthetic corpus, keep the fastest, cache per (backend, device
        kind, geometry, mesh size)."""
        from ..ops import autotune
        candidates = autotune.engine_candidates(self.tables,
                                                self._snap.stepped)
        choice = "gather"
        if len(candidates) > 1:
            key = autotune.geometry_key(
                self.tables.n_states, self.V,
                self.step_k) + f"|mesh{self.n_dev}"
            choice = None if force else autotune.cached_choice(key)
            if choice not in candidates:
                choice = autotune.probe(self, candidates)
                autotune.store_choice(key, choice)
        self._engine = choice
        self._bind_kernels()

    # Snapshot delegation (mirrors DenseScanner).
    @property
    def tables(self):
        return self._snap.tables

    @property
    def V(self) -> int:
        return self._snap.V

    @property
    def step_k(self) -> int:
        return self._snap.step_k

    @property
    def _stepped(self):
        return self._snap.stepped

    @property
    def _dflat(self):
        return self._snap.dflat

    @property
    def _nb_out(self):
        return self._snap.nb_out

    @property
    def _st_packed(self):
        return self._snap.st_dev[0]

    @property
    def version(self) -> int:
        return self.tables.version

    def _bind_kernels(self) -> None:
        """(Re)bind the shard_map kernels to the snapshot's geometry; the
        factories are lru-cached on their constants, so this compiles
        something new only when V / halo / k / count_bits changed."""
        self._count = make_sharded_count(self.mesh, self.V, self.halo,
                                         self._n_streams_per_device,
                                         self.axis_name)
        self._scan = make_sharded_scan_states(self.mesh, self.V, self.halo,
                                              self._n_streams_per_device,
                                              self.axis_name)
        st = self._snap.stepped
        if st is not None:
            self._halo_steps = -(-self.halo // st.k)
            self._halo_sym = self._halo_steps * st.k
            self._stepped_count = make_sharded_stepped_count(
                self.mesh, st.V, st.k, st.Vk, st.count_bits,
                self._halo_steps, self._n_streams_per_device, self.axis_name)
        else:
            self._halo_steps = 0
            self._halo_sym = 0
        # Count engine: the same rule as DenseScanner
        # (ops/autotune.resolve_engine), planes replicated.
        from ..ops import autotune
        self._mxu, self._hybrid = autotune.resolve_engine(
            self._engine, self.tables, st,
            lambda a: jax.device_put(a, self._repl))

    def refresh(self) -> bool:
        """Catch the replicated device snapshot up with the machine's
        current dictionary — the mesh-wide sibling of DenseScanner.refresh
        (same semantics: True = in-place cell scatter, False = transparent
        full rebuild; serialize against in-flight scans, buffers are
        donated). The scatter executes replicated on every device, so the
        update costs one host->device transfer of the changed cells and no
        collective traffic."""
        with self._dispatch:
            new = self.machine.compile()
            if new.version == self.tables.version:
                return True
            status = self._snap.refresh(new)
            need = max(new.max_depth - 1, 0)
            if need > self.halo:
                self.halo = -(-need // 8) * 8
            self._bind_kernels()
            return status != "rebuild"

    def encode(self, signs) -> np.ndarray:
        """Map signs to dense letter ids (OOV -> 0); int32 arrays pass
        through as pre-encoded ids — mirrors DenseScanner.encode."""
        from ..models.scanner import encode_signs
        return encode_signs(self.machine, signs, self.V)

    def _get_lut(self, kind: str):
        from ..models.scanner import raw_lut_entry
        return raw_lut_entry(
            self.machine, self.V, self.tables, kind,
            self._device_encode_max_cp, self._lut_cache,
            lambda lut: jax.device_put(np.asarray(lut), self._repl))

    def _raw_stream(self, signs):
        """(raw symbol ndarray, replicated lut entry) for the mesh-wide
        device-side encode, or None — mirrors DenseScanner._raw_stream."""
        from ..models.scanner import raw_stream_for
        if not self._device_encode:
            return None
        return raw_stream_for(self.machine, signs, self._get_lut)

    def _count_raw(self, raw: np.ndarray, ent, head) -> Optional[int]:
        """Raw-path sharded count: raw symbols upload sharded (1 byte per
        symbol for byte corpora, 4x less wire than ids), the replicated
        LUT encodes inside each shard's kernel, and the halo handoff rides
        the encoded stream. Returns None when the active engine has no raw
        kernel (unpacked stepped fallback) — caller host-encodes."""
        lut_dev = ent[0]
        T = len(raw)
        min_shard = max(self.halo, self._halo_sym, 1)
        Tp = max(-(-T // self.n_dev), min_shard) * self.n_dev
        if Tp != T:
            raw = np.concatenate([raw, np.zeros(Tp - T, raw.dtype)])
        placed = jax.device_put(np.ascontiguousarray(raw), self._shard)
        self._guard_acc(Tp)
        st = self._stepped
        if self._mxu is not None:
            planes, cbits, n_planes, S_pad = self._mxu
            fn = make_sharded_mxu_count(
                self.mesh, self.V, S_pad, cbits, n_planes, self.halo,
                self._n_streams_per_device, self.axis_name, raw=True)
            per = fn(planes, placed, head=self._head_arr(head, self.halo),
                     lut=lut_dev)
        elif self._hybrid is not None:
            planes, cbm, n_planes, S_pad = self._hybrid
            fn = make_sharded_hybrid_count(
                self.mesh, st.V, st.k, st.Vk, st.count_bits,
                self._halo_steps, S_pad, n_planes, cbm,
                self._n_streams_per_device, self.axis_name, raw=True)
            per = fn(self._st_packed, planes, placed,
                     head=self._head_arr(head, self._halo_sym), lut=lut_dev)
        elif st is not None and st.packed is not None:
            fn = make_sharded_stepped_count(
                self.mesh, st.V, st.k, st.Vk, st.count_bits,
                self._halo_steps, self._n_streams_per_device,
                self.axis_name, raw=True)
            per = fn(self._st_packed, placed,
                     head=self._head_arr(head, self._halo_sym), lut=lut_dev)
        elif st is not None:
            return None  # unpacked two-table fallback: host path
        else:
            fn = make_sharded_count(
                self.mesh, self.V, self.halo, self._n_streams_per_device,
                self.axis_name, raw=True)
            per = fn(self._dflat, self._nb_out, placed,
                     head=self._head_arr(head, self.halo), lut=lut_dev)
        return int(np.asarray(per).sum(dtype=np.int64))

    def _pad_and_place(self, ids: np.ndarray):
        T = len(ids)
        min_shard = max(self.halo, self._halo_sym, 1)
        Tp = max(-(-T // self.n_dev), min_shard) * self.n_dev
        if Tp != T:
            ids = np.concatenate([ids, np.zeros(Tp - T, np.int32)])
        return jax.device_put(np.ascontiguousarray(ids), self._shard), T

    def _head_arr(self, head, halo: int):
        """Session carry as a fixed-length replicated [halo] array (zeros
        at the front when the previous chunk was shorter than the halo)."""
        if head is None or halo == 0 or len(head) == 0:
            return None
        out = np.zeros(halo, np.int32)
        tail = np.asarray(head, np.int32)[-halo:]
        out[halo - len(tail):] = tail
        return out

    def _guard_acc(self, T_padded: int) -> None:
        """Pre-dispatch int32 per-stream accumulator guard (same bound as
        DenseScanner._guard_acc: L symbols x max matches/position must stay
        below 2^31 — the first level of the two-level reduction)."""
        Tl = T_padded // self.n_dev
        B = min(self._n_streams_per_device, max(1, Tl // 64))
        L = -(-Tl // B)
        if L * max(self._snap.max_nb, 1) >= 2 ** 31:
            raise ValueError(
                f"a per-device stream of {L} symbols with up to "
                f"{self._snap.max_nb} matches/position could overflow the "
                "int32 per-stream accumulator; chunk the input with "
                "scanner.session() or raise n_streams_per_device")

    def count(self, signs, head=None) -> int:
        with self._dispatch:
            return self._count_locked(signs, head)

    def _count_locked(self, signs, head) -> int:
        from ..models.scanner import _is_device_array
        if _is_device_array(signs):
            # Device-resident mesh input (serving a corpus already placed
            # across the mesh): no host staging, no per-call device_put —
            # which costs ~0.5 s per 128 MB on a MULTI-PROCESS mesh (no
            # zero-copy aliasing across processes, measured; the mesh
            # sibling of DenseScanner's jax.Array fast path). The caller
            # guarantees values lie in [0, V).
            return self._count_device(signs, head)
        dense_verdict = False
        if self._prefilter != "off" and len(signs):
            # Raw-input dead-block elision, mesh-wide: filter + window
            # gather on host BEFORE any encode; only the live windows
            # upload, sharded across the mesh (round 4 — the sibling of
            # DenseScanner._sparse_count_raw).
            raw = self._raw_stream(signs)
            if raw is not None:
                n = self._sparse_count_raw(raw[0], raw[1], head)
                if isinstance(n, int):
                    return n
                if n == "dense":
                    # The filter already judged the corpus dense; remember
                    # it so the id path below does not re-run the sparse
                    # prefilter over the whole corpus (ADVICE r4).
                    dense_verdict = True
                    n = self._count_raw(raw[0], raw[1], head)
                    if n is not None:
                        return n
        if self._prefilter == "off" and len(signs):
            raw = self._raw_stream(signs)
            if raw is not None:
                n = self._count_raw(raw[0], raw[1], head)
                if n is not None:
                    return n
        ids = self.encode(signs)
        if len(ids) == 0:
            return 0
        if self._prefilter != "off" and not dense_verdict:
            n = self._sparse_count(ids, head)
            if n is not None:
                return n
        placed, _ = self._pad_and_place(ids)
        return self._count_placed(placed, head)

    def _count_device(self, ids, head) -> int:
        placed, T = self._placed_for(ids)
        if placed is None:
            return 0
        if self._prefilter != "off":
            # Device-resident mesh sparse count (round 5): block filter
            # + windowed count per shard, zero per-call corpus upload —
            # the mesh sibling of DenseScanner._sparse_count_device.
            n = self._sparse_count_device(placed, T, head)
            if n is not None:
                return n
        return self._count_placed(placed, head)

    def _sparse_count_device(self, placed, T: int, head):
        """Filter-then-verify count over a resident mesh corpus (dense-
        table windowed core). Returns None when not applicable (halo
        wider than a block, misaligned shards, or the auto-density gate
        declines) — caller takes the dense resident kernels."""
        halo, L_blk = self.halo, 128
        if halo > L_blk:
            return None
        Tl = int(placed.shape[0]) // self.n_dev
        if Tl % L_blk:
            return None
        nB_loc = Tl // L_blk
        filt = make_sharded_block_filter(self.mesh, L_blk, nB_loc,
                                         self.axis_name)
        order, n_live_all = filt(placed)
        n_live = np.asarray(n_live_all).reshape(-1)
        total_live = int(n_live.sum())
        nB_real = -(-T // L_blk)
        self.stats["sparse_live_frac"] = total_live / max(nB_real, 1)
        if total_live == 0:
            return 0
        if self._prefilter == "auto" and total_live * 2 > nB_real:
            return None
        cap = min(nB_loc,
                  max(8, 1 << (int(n_live.max()) - 1).bit_length()))
        fn = make_sharded_sparse_count_dev(self.mesh, self.V, halo,
                                           L_blk, nB_loc, cap,
                                           self.axis_name)
        per = fn(self._dflat, self._nb_out, placed, order, n_live_all,
                 head=self._head_arr(head, halo))
        return int(np.asarray(per).sum(dtype=np.int64))

    def _count_placed(self, placed, head) -> int:
        self._guard_acc(placed.shape[0])
        if self._mxu is not None:
            planes, cbits, n_planes, S_pad = self._mxu
            fn = make_sharded_mxu_count(
                self.mesh, self.V, S_pad, cbits, n_planes, self.halo,
                self._n_streams_per_device, self.axis_name)
            per_stream = fn(planes, placed,
                            head=self._head_arr(head, self.halo))
        elif self._hybrid is not None:
            planes, cbm, n_planes, S_pad = self._hybrid
            st = self._stepped
            fn = make_sharded_hybrid_count(
                self.mesh, st.V, st.k, st.Vk, st.count_bits,
                self._halo_steps, S_pad, n_planes, cbm,
                self._n_streams_per_device, self.axis_name)
            per_stream = fn(self._st_packed, planes, placed,
                            head=self._head_arr(head, self._halo_sym))
        elif self._stepped is not None:
            per_stream = self._stepped_count(
                self._st_packed, placed,
                head=self._head_arr(head, self._halo_sym))
        else:
            per_stream = self._count(self._dflat, self._nb_out, placed,
                                     head=self._head_arr(head, self.halo))
        # int64 grand total on host (two-level reduction: int32 per stream
        # on device, exact combine here — no 2^31 mesh-wide cap).
        return int(np.asarray(per_stream).sum(dtype=np.int64))

    def _sparse_count_raw(self, raw: np.ndarray, ent, head):
        """Mesh raw-input sparse count with host dead-block elision:
        the shared ops/sparse.raw_elision_plan decides (one copy of the
        policy with the single-chip scanner), elide_windows
        gathers/encodes only the live windows (columns padded to a mesh
        multiple), and make_sharded_elided_count scans them sharded —
        windows are self-contained, so no halo collective. Returns an
        int, "dense" (auto gate: take the dense raw engines without
        re-filtering), or None (id path decides)."""
        from ..ops.sparse import elide_windows, raw_elision_plan
        lut_host, n_lut = ent[3], ent[1]
        st = self._stepped
        use_stepped = (self._mxu is None and st is not None
                       and st.packed is not None)
        k = st.k if use_stepped else 1
        halo = self._halo_sym if use_stepped else self.halo
        L_blk = 128 * k
        T = len(raw)
        verdict, live, n_live, nB_real = raw_elision_plan(
            raw, lut_host, n_lut, self._prefilter, halo, L_blk)
        if live is not None:
            self.stats["sparse_live_frac"] = n_live / max(nB_real, 1)
        if verdict == "zero":
            return 0
        if verdict in ("dense", "na"):
            return "dense" if verdict == "dense" else None
        tm, _ = elide_windows(raw, (lut_host, n_lut), T, live, n_live,
                              head, halo, L_blk, nB_real,
                              pad_cols_to=self.n_dev)
        if (halo + L_blk) * max(self._snap.max_nb, 1) >= 2 ** 31:
            raise ValueError("window accumulator could overflow int32")
        placed = jax.device_put(
            tm, NamedSharding(self.mesh, P(None, self.axis_name)))
        if use_stepped:
            fn = make_sharded_elided_count(
                self.mesh, st.V, st.k, st.Vk, st.count_bits,
                self._halo_steps, True, self.axis_name)
            per = fn(self._st_packed, self._nb_out, placed)
        else:
            fn = make_sharded_elided_count(
                self.mesh, self.V, 1, self.V, 0, self.halo, False,
                self.axis_name)
            per = fn(self._dflat, self._nb_out, placed)
        self.stats["sparse_elided_upload_bytes"] = int(tm.nbytes)
        return int(np.asarray(per).sum(dtype=np.int64))

    def _sparse_count(self, ids: np.ndarray, head) -> Optional[int]:
        """Sharded filter-then-verify count: the host bandwidth pass marks
        live L_blk-symbol blocks PER SHARD; each device gathers and scans
        only its own live windows (make_sharded_sparse_count), with the
        cross-shard halo on the ppermute handoff. Returns None when not
        profitable ("auto" with more than half the blocks live) or not
        applicable, falling through to the dense mesh kernels — the mesh
        sibling of DenseScanner._sparse_count."""
        from ..ops import sparse
        st = self._stepped
        use_stepped = (self._mxu is None and st is not None
                       and st.packed is not None)
        k = st.k if use_stepped else 1
        halo = self._halo_sym if use_stepped else self.halo
        L_blk = 128 * k
        if halo > L_blk:
            return None
        T = len(ids)
        nB_real = -(-T // L_blk)
        # per-shard block grid, pow2-bucketed so steady sizes reuse kernels
        nB_min = max(1, -(-T // (self.n_dev * L_blk)))
        nB_loc = 1 << (nB_min - 1).bit_length()
        Tp = self.n_dev * nB_loc * L_blk
        if Tp != T:
            ids = np.concatenate([ids, np.zeros(Tp - T, np.int32)])
        live = sparse.live_blocks(ids, L_blk).reshape(self.n_dev, nB_loc)
        n_live = live.sum(axis=1)
        total_live = int(n_live.sum())
        self.stats["sparse_live_frac"] = total_live / max(nB_real, 1)
        if total_live == 0:
            return 0  # all-OOV: nothing can match, no device launch
        if self._prefilter == "auto" and total_live * 2 > nB_real:
            return None
        cap = max(8, 1 << (int(n_live.max()) - 1).bit_length())
        idx = np.full((self.n_dev, cap), nB_loc, np.int32)  # pad -> spare
        for d in range(self.n_dev):
            w = np.flatnonzero(live[d])
            idx[d, :len(w)] = w
        placed_ids = jax.device_put(np.ascontiguousarray(ids), self._shard)
        placed_idx = jax.device_put(idx.reshape(-1), self._shard)
        head_arr = self._head_arr(head, halo)
        if use_stepped:
            fn = make_sharded_sparse_count(
                self.mesh, st.V, st.k, st.Vk, st.count_bits,
                self._halo_steps, L_blk, nB_loc, cap, True, self.axis_name)
            per = fn(self._st_packed, self._nb_out, placed_ids, placed_idx,
                     head=head_arr)
        else:
            fn = make_sharded_sparse_count(
                self.mesh, self.V, 1, self.V, 0, self.halo, L_blk, nB_loc,
                cap, False, self.axis_name)
            per = fn(self._dflat, self._nb_out, placed_ids, placed_idx,
                     head=head_arr)
        return int(np.asarray(per).sum(dtype=np.int64))

    def _placed_for(self, signs):
        """(placed device array, T) for either host signs (encode + pad +
        device_put) or a pre-placed jax.Array (validated, no staging)."""
        from ..models.scanner import _is_device_array
        if _is_device_array(signs):
            import jax.numpy as jnp
            if not jnp.issubdtype(signs.dtype, jnp.integer):
                raise ValueError(
                    "device-array input must be integer letter ids "
                    f"(got dtype {signs.dtype})")
            T = int(signs.shape[0])
            if T == 0:
                return None, 0
            min_shard = max(self.halo, self._halo_sym, 1)
            if T % self.n_dev or T // self.n_dev < min_shard:
                raise ValueError(
                    f"device-resident mesh input length {T} must be "
                    f"divisible by the {self.n_dev}-device mesh with at "
                    f"least {min_shard} symbols per shard; pad with OOV "
                    "id 0")
            placed = (signs if signs.dtype == jnp.int32
                      else signs.astype(jnp.int32))
            return placed, T
        ids = self.encode(signs)
        if len(ids) == 0:
            return None, 0
        return self._pad_and_place(ids)

    def scan_states(self, signs, head=None) -> np.ndarray:
        with self._dispatch:
            placed, T = self._placed_for(signs)
            if placed is None:
                return np.zeros(0, np.int32)
            return np.asarray(
                self._scan(self._dflat, placed,
                           head=self._head_arr(head, self.halo)))[:T]

    def count_many(self, docs) -> np.ndarray:
        """Per-document match counts for a batch of independent documents in
        ONE mesh-wide launch — the sharded sibling of
        DenseScanner.count_many: documents are dealt across devices along
        the stream axis (each document is one stream column, starting at
        the root; OOV padding is inert, reference modification [3]).
        Returns int64 counts, len(docs).

        Round 5 (VERDICT r4 #6): raw staging when every document rides
        one LUT (byte batches upload 1 byte/symbol sharded — 4x less
        wire, encode in-kernel), and pre-placed device-resident [L, B]
        id batches launch with no host staging."""
        from ..models.scanner import DenseScanner, _is_device_array
        if _is_device_array(docs):
            return self._count_many_device(docs)
        n = len(docs)
        if n == 0:
            return np.zeros(0, np.int64)
        k = (self._stepped.k
             if self._stepped is not None and self._mxu is None else 1)
        unit = 128 * k
        raws = DenseScanner._raw_docs(self, docs)
        if raws is not None:
            docs_arrs, ent = raws
        else:
            docs_arrs, ent = [self.encode(d) for d in docs], None
        # Length-bucketed launches (mirrors DenseScanner.count_many): one
        # long outlier costs only its own bucket, not the whole batch.
        lengths = np.asarray([len(e) for e in docs_arrs], np.int64)
        out = np.zeros(n, np.int64)
        with self._dispatch:
            for L, idx in DenseScanner._length_buckets(lengths, unit):
                out[idx] = self._count_many_launch(
                    [docs_arrs[i] for i in idx], L, ent)
        return out

    def _count_many_device(self, tm) -> np.ndarray:
        """Device-resident mesh batch scoring: ``tm`` [L, B] letter ids
        (jax.Array, B a multiple of the mesh size), documents as columns,
        OOV-0 padded. Resharded along the document axis if not already
        placed; no host staging."""
        if tm.ndim != 2:
            raise ValueError(
                f"device-resident batch must be [L, B] (got {tm.ndim}-D)")
        if not jnp.issubdtype(tm.dtype, jnp.integer):
            raise ValueError(
                "device-resident batch must be integer letter ids "
                f"(got dtype {tm.dtype})")
        L, B = int(tm.shape[0]), int(tm.shape[1])
        if B % self.n_dev:
            raise ValueError(
                f"batch width {B} must be divisible by the "
                f"{self.n_dev}-device mesh (pad with all-OOV columns)")
        if tm.dtype != jnp.int32:
            tm = tm.astype(jnp.int32)
        with self._dispatch:
            per = self._count_many_kernel(tm, L, B // self.n_dev)
        return np.asarray(per).reshape(-1).astype(np.int64)

    def _count_many_launch(self, encoded, L: int, ent=None) -> np.ndarray:
        n = len(encoded)
        # B bucketed to a multiple of 8 per device so steady batch sizes
        # reuse one compiled kernel.
        per_dev = -(-(-(-n // self.n_dev)) // 8) * 8
        B = per_dev * self.n_dev
        tm = np.zeros((L, B),
                      encoded[0].dtype if ent is not None else np.int32)
        for j, e in enumerate(encoded):
            tm[:len(e), j] = e
        placed = jax.device_put(
            tm, NamedSharding(self.mesh, P(None, self.axis_name)))
        per = self._count_many_kernel(placed, L, per_dev, ent)
        return np.asarray(per).reshape(-1)[:n].astype(np.int64)

    def _count_many_kernel(self, placed, L: int, B_local: int, ent=None):
        """Dispatch one sharded [L, B] batch through the engine's
        count_many kernel (make_sharded_count_many) with raw encode and
        per-document block splitting as applicable; per-document combine
        happens in-shard, result keeps the [n_dev, B_local] all_gather
        convention."""
        if L * max(self._snap.max_nb, 1) >= 2 ** 31:
            raise ValueError(
                f"a document stream of {L} symbols could overflow the "
                "int32 per-stream accumulator; split the document")
        raw = ent is not None
        st = self._stepped
        if self._mxu is not None:
            planes, cbits, n_planes, S_pad = self._mxu
            c, Lp = self._split_for(L, B_local, 128)
            fn = make_sharded_count_many(
                self.mesh, "mxu",
                (self.V, S_pad, cbits, n_planes, self.halo),
                self.halo, c, Lp, raw, self.axis_name)
            return (fn(planes, ent[0], placed) if raw
                    else fn(planes, placed))
        if st is not None and st.packed is not None and L % st.k == 0:
            c, Lp = self._split_for(L, B_local, 128 * st.k)
            fn = make_sharded_count_many(
                self.mesh, "stepped",
                (st.V, st.k, st.Vk, st.count_bits, self._halo_steps),
                self._halo_sym, c, Lp, raw, self.axis_name)
            return (fn(self._st_packed, ent[0], placed) if raw
                    else fn(self._st_packed, placed))
        c, Lp = self._split_for(L, B_local, 128)
        fn = make_sharded_count_many(
            self.mesh, "dense", (self.V,), self.halo, c, Lp, raw,
            self.axis_name)
        return (fn(self._dflat, self._nb_out, ent[0], placed) if raw
                else fn(self._dflat, self._nb_out, placed))

    def _split_for(self, L: int, n_cols_local: int, unit: int):
        """Per-document block split on the mesh (round 5): target each
        shard's configured stream width — mirrors
        DenseScanner._split_for."""
        target = self._n_streams_per_device
        c = min(-(-target // max(n_cols_local, 1)), max(L // unit, 1))
        if c <= 1:
            return 1, L
        Lp = -(-(-(-L // c)) // unit) * unit
        return -(-L // Lp), Lp

    def session(self) -> "StreamSession":
        """Open a chunked streaming session over the mesh (exact across
        chunk edges — the carry rides into shard 0's halo via the replicated
        head argument; all other shards keep the ppermute handoff). Same
        cursor contract as the single-chip session (reference c:433-448)."""
        from ..models.scanner import StreamSession
        return StreamSession(self)

    def find_matches(self, signs, offset: int = 0, head=None,
                     max_hits_per_shard: Optional[int] = None):
        """(event, Match) occurrences across the sharded stream, reference
        index order — the mesh-wide sibling of DenseScanner.find_matches.

        ``head``: session carry (previous chunk tail ids) for shard 0's halo.
        ``max_hits_per_shard``: bound the per-shard hit buffers of the
        all_gather bounded-hit path (only hits travel; raises if any
        shard overflows). With NO bound (the default) the buffers
        AUTO-SIZE in ONE corpus pass (round 5): the count-speed scan
        phase leaves each shard's emit array resident and returns the
        per-shard live/hit counters, and the extract phase compiles at
        their pow2 buckets — per-device memory scales with the densest
        shard, overflow is structurally impossible. Prefilter scanners
        default to the sparse/elided bounded path the same way. Engines
        without a packed table fall back to the full per-position decode.

        Returns a columnar ``MatchSet`` (models/results.py) — list-
        compatible, arrays for the bulk data."""
        with self._dispatch:
            return self._find_matches_locked(signs, offset, head,
                                             max_hits_per_shard)

    def _find_matches_locked(self, signs, offset, head,
                             max_hits_per_shard):
        from ..models.results import MatchSet
        from ..ops.decode import decode_matches_arrays, expand_hits_arrays
        auto = max_hits_per_shard is None
        from ..models.scanner import _is_device_array
        key = None if auto else int(max_hits_per_shard)
        if self._prefilter != "off" and _is_device_array(signs) \
                and int(signs.shape[0]):
            # Device-resident mesh corpus with a prefilter (VERDICT r4
            # #3): block filter on device per shard, windowed retrieval
            # over live windows only — zero per-call corpus upload.
            out = self._sparse_hits_device(signs, offset, head, key)
            if out is not None:
                return out
        if self._prefilter != "off" and not _is_device_array(signs) \
                and len(signs):
            # Sparse retrieval is the DEFAULT on prefilter scanners
            # (VERDICT r4 #1, mesh side): auto (key=None) sizes the
            # per-shard hit buffers from the live-window counts — a live
            # window holds at most L_blk hit positions, structurally.
            raw = self._raw_stream(signs)
            verdict = None
            if raw is not None:
                from ..ops.sparse import raw_elision_plan
                verdict, live, n_live, nB_real = raw_elision_plan(
                    raw[0], raw[1][3], raw[1][1], self._prefilter,
                    self.halo, 128)
                if live is not None:
                    self.stats["sparse_live_frac"] = \
                        n_live / max(nB_real, 1)
                if verdict == "zero":
                    return MatchSet(self.machine, self.tables,
                                    np.zeros(0, np.int64),
                                    np.zeros(0, np.int32),
                                    np.zeros(0, np.int32))
                if verdict == "elide":
                    return self._elided_hits(
                        raw[0], (raw[1][3], raw[1][1]), len(raw[0]),
                        live, n_live, offset, head, nB_real, key)
            if verdict != "dense":
                ids = self.encode(signs)
                if len(ids) == 0:
                    return MatchSet(self.machine, self.tables,
                                    np.zeros(0, np.int64),
                                    np.zeros(0, np.int32),
                                    np.zeros(0, np.int32))
                out = self._sparse_hits(ids, offset, head, key)
                if out is not None:
                    return out
                signs = ids  # already encoded: _placed_for reuses it
        st = self._stepped
        if auto:
            if (st is not None and st.packed is not None
                    and self._mxu is None and len(signs)):
                # Single-pass auto retrieval (VERDICT r4 #2): phase A is
                # the count-speed scan leaving emit sharded on device;
                # buffers then size from the PER-SHARD counters it
                # already returned — no separate count() pass.
                return self._auto_stepped_hits(signs, offset, head)
            states = self.scan_states(signs, head=head)
            ends, end_states, idx = decode_matches_arrays(
                states, self.tables, offset)
            return MatchSet(self.machine, self.tables, ends,
                            end_states, idx)
        placed, T = self._placed_for(signs)
        if placed is None:
            return MatchSet(self.machine, self.tables,
                            np.zeros(0, np.int64), np.zeros(0, np.int32),
                            np.zeros(0, np.int32))
        from ..models.scanner import _guard_pos32
        _guard_pos32(T)
        if st is not None and st.packed is not None and self._mxu is None:
            # Retrieval at count-engine speed (VERDICT r3 #3), mesh-wide.
            hits_fn = make_sharded_stepped_hits(
                self.mesh, st.V, st.k, st.Vk, st.count_bits,
                self._halo_steps, key, self._n_streams_per_device,
                self.axis_name)
            positions, sts, n_hit_pos, n_live = hits_fn(
                self._st_packed, self._dflat, self._nb_out, placed,
                head=self._head_arr(head, self._halo_sym))
            n_live = np.asarray(n_live)
            if int(n_live.max()) > key:
                raise ValueError(
                    f"a shard has at least {int(n_live.max())} matching "
                    f"positions, over max_hits_per_shard={key}")
        else:
            # lru-cached factory: recompiles only for a new (halo, max,...)
            hits_fn = make_sharded_hits(self.mesh, self.V, self.halo, key,
                                        self._n_streams_per_device,
                                        self.axis_name)
            positions, sts, n_hit_pos = hits_fn(
                self._dflat, self._nb_out, placed,
                head=self._head_arr(head, self.halo))
        n_hit_pos = np.asarray(n_hit_pos)
        if int(n_hit_pos.max()) > key:
            raise ValueError(
                f"a shard has {int(n_hit_pos.max())} matching positions, "
                f"over max_hits_per_shard={key}")
        positions = np.asarray(positions).reshape(-1)
        sts = np.asarray(sts).reshape(-1)
        keep = (positions >= 0) & (positions < T)
        positions, sts = positions[keep], sts[keep]
        order = np.argsort(positions, kind="stable")
        ends, end_states, idx = expand_hits_arrays(
            positions[order], sts[order], self.tables, offset)
        return MatchSet(self.machine, self.tables, ends, end_states, idx)

    def _auto_stepped_hits(self, signs, offset, head):
        """Single-pass auto-sized mesh retrieval (VERDICT r4 #2 + ADVICE
        r4 medium): phase A scans once at count-engine speed, keeping the
        per-shard emit arrays sharded on device; the host syncs only the
        tiny per-shard counters and compiles phase B at the pow2 bucket
        of the PER-SHARD live/hit maxima — per-device memory scales with
        the densest shard, not n_dev x the global total."""
        from ..models.results import MatchSet
        from ..models.scanner import _guard_pos32
        from ..ops.decode import expand_hits_arrays
        st = self._stepped
        placed, T = self._placed_for(signs)
        if placed is None:
            return MatchSet(self.machine, self.tables,
                            np.zeros(0, np.int64), np.zeros(0, np.int32),
                            np.zeros(0, np.int32))
        _guard_pos32(T)
        # per-stream int32 n_hits must not wrap before the int64 host
        # combine (review r5): bound L exactly as the scan phase lays it
        # out per shard
        _, L_sh = _stepped_geometry(int(placed.shape[0]) // self.n_dev,
                                    st.k, self._n_streams_per_device)
        if L_sh * max(self._snap.max_nb, 1) >= 2 ** 31:
            raise ValueError(
                f"a per-device stream of {L_sh} symbols with up to "
                f"{self._snap.max_nb} matches/position could overflow "
                "the int32 per-stream counters; chunk the input with "
                "scanner.session() or raise n_streams_per_device")
        scan_fn = make_sharded_stepped_hits_scan(
            self.mesh, st.V, st.k, st.Vk, st.count_bits,
            self._halo_steps, self._n_streams_per_device, self.axis_name)
        hd = self._head_arr(head, self._halo_sym)
        emit, n_hits_db, n_live_d = scan_fn(self._st_packed, placed,
                                            head=hd)
        n_live = np.asarray(n_live_d).reshape(-1)          # [D]
        max_live = int(n_live.max())
        if max_live == 0:
            return MatchSet(self.machine, self.tables,
                            np.zeros(0, np.int64), np.zeros(0, np.int32),
                            np.zeros(0, np.int32))
        # Per-shard exact totals: [D, B] int32 per-stream counts, int64
        # combine on host (two-level reduction, no 2^31 wrap).
        n_hits_sh = (np.asarray(n_hits_db).reshape(self.n_dev, -1)
                     .sum(axis=1, dtype=np.int64))
        cap = max(8, 1 << (max_live - 1).bit_length())
        max_sh = int(n_hits_sh.max())
        out_size = min(cap * st.k,
                       max(8, 1 << (max(max_sh, 1) - 1).bit_length()))
        if (self.n_dev * out_size * 8 > T * 4
                and self.n_dev * out_size * 8 > _AUTO_DECODE_FLOOR_BYTES):
            # Extreme match density AT SCALE: the replicated per-shard
            # hit buffers (n_dev x out_size x 8 bytes per device) would
            # exceed the full per-position decode's states array — fall
            # back to the decode, which is leaner there (ADVICE r4:
            # never let the auto path cost more memory than what it
            # replaces). The 64 MB floor keeps toy inputs on the fast
            # path, where both footprints are trivial.
            from ..ops.decode import decode_matches_arrays
            states = self.scan_states(signs, head=head)
            ends, end_states, idx = decode_matches_arrays(
                states, self.tables, offset)
            return MatchSet(self.machine, self.tables, ends,
                            end_states, idx)
        ext_fn = make_sharded_stepped_hits_extract(
            self.mesh, st.V, st.k, st.count_bits, self._halo_steps,
            cap, out_size, self._n_streams_per_device, self.axis_name)
        positions, sts = ext_fn(self._dflat, self._nb_out, placed, emit,
                                head=hd)
        positions = np.asarray(positions).reshape(-1)
        sts = np.asarray(sts).reshape(-1)
        keep = (positions >= 0) & (positions < T)
        positions, sts = positions[keep], sts[keep]
        order = np.argsort(positions, kind="stable")
        ends, end_states, idx = expand_hits_arrays(
            positions[order], sts[order], self.tables, offset)
        return MatchSet(self.machine, self.tables, ends, end_states, idx)

    def _elided_hits(self, arr, lut, T: int, live, n_live: int, offset,
                     head, nB_real: int, max_hits_per_shard):
        """Mesh bounded hits over host-elided windows: only the live
        windows upload, sharded along the window axis; positions are
        absolute via the sharded block-index array. The mesh sibling of
        DenseScanner._elided_hits. ``max_hits_per_shard=None`` = AUTO:
        per-shard buffers size to (windows per shard) * L_blk — the
        structural bound, so no overflow raise."""
        from ..models.results import MatchSet
        from ..models.scanner import _guard_pos32
        from ..ops.decode import expand_hits_arrays
        from ..ops.sparse import elide_windows
        _guard_pos32(T)
        halo, L_blk = self.halo, 128
        tm, idx = elide_windows(arr, lut, T, live, n_live, head, halo,
                                L_blk, nB_real, pad_cols_to=self.n_dev)
        auto = max_hits_per_shard is None
        if auto:
            per_shard = idx.shape[0] // self.n_dev
            max_hits_per_shard = max(
                8, 1 << (per_shard * L_blk - 1).bit_length())
        placed_tm = jax.device_put(
            tm, NamedSharding(self.mesh, P(None, self.axis_name)))
        placed_idx = jax.device_put(idx.astype(np.int32), self._shard)
        fn = make_sharded_elided_hits(self.mesh, self.V, halo, L_blk,
                                      max_hits_per_shard, self.axis_name)
        positions, sts, n_hit_pos = fn(self._dflat, self._nb_out,
                                       placed_tm, placed_idx)
        n_hit_pos = np.asarray(n_hit_pos)
        if not auto and int(n_hit_pos.max()) > max_hits_per_shard:
            raise ValueError(
                f"a shard has {int(n_hit_pos.max())} matching positions, "
                f"over max_hits_per_shard={max_hits_per_shard}")
        positions = np.asarray(positions).reshape(-1)
        sts = np.asarray(sts).reshape(-1)
        keep = (positions >= 0) & (positions < T)
        positions, sts = positions[keep], sts[keep]
        order = np.argsort(positions, kind="stable")
        self.stats["sparse_elided_upload_bytes"] = int(tm.nbytes)
        ends, end_states, idx_out = expand_hits_arrays(
            positions[order], sts[order], self.tables, offset)
        return MatchSet(self.machine, self.tables, ends, end_states,
                        idx_out)

    def _sparse_hits_device(self, ids, offset, head, max_hits):
        """Device-resident mesh sparse retrieval (round 5, VERDICT r4
        #3): the corpus stays pinned across the mesh; each shard filters
        and scans only its live windows on device. Returns None when not
        applicable (halo wider than a block, shard length not a block
        multiple, or the auto-density gate fires) — caller falls through
        to the dense resident-corpus kernels. ``max_hits=None`` = AUTO
        with the structural cap * L_blk per-shard bound (no raise)."""
        from ..models.results import MatchSet
        from ..models.scanner import _guard_pos32
        from ..ops.decode import expand_hits_arrays
        if not jnp.issubdtype(ids.dtype, jnp.integer):
            raise ValueError(
                "device-array input must be integer letter ids "
                f"(got dtype {ids.dtype})")
        halo, L_blk = self.halo, 128
        if halo > L_blk:
            return None
        placed, T = self._placed_for(ids)
        if placed is None:
            return MatchSet(self.machine, self.tables,
                            np.zeros(0, np.int64), np.zeros(0, np.int32),
                            np.zeros(0, np.int32))
        _guard_pos32(T)
        Tl = int(placed.shape[0]) // self.n_dev
        if Tl % L_blk:
            return None
        nB_loc = Tl // L_blk
        filt = make_sharded_block_filter(self.mesh, L_blk, nB_loc,
                                         self.axis_name)
        order, n_live_all = filt(placed)
        n_live = np.asarray(n_live_all).reshape(-1)       # [D]
        total_live = int(n_live.sum())
        nB_real = -(-T // L_blk)
        self.stats["sparse_live_frac"] = total_live / max(nB_real, 1)
        if total_live == 0:
            return MatchSet(self.machine, self.tables,
                            np.zeros(0, np.int64), np.zeros(0, np.int32),
                            np.zeros(0, np.int32))
        if self._prefilter == "auto" and total_live * 2 > nB_real:
            return None
        cap = min(nB_loc,
                  max(8, 1 << (int(n_live.max()) - 1).bit_length()))
        auto = max_hits is None
        if auto:
            max_hits = cap * L_blk   # structural per-shard bound
        fn = make_sharded_sparse_hits_dev(
            self.mesh, self.V, halo, L_blk, nB_loc, cap, int(max_hits),
            self.axis_name)
        positions, sts, n_hit_pos = fn(
            self._dflat, self._nb_out, placed, order, n_live_all,
            head=self._head_arr(head, halo))
        n_hit_pos = np.asarray(n_hit_pos)
        if not auto and int(n_hit_pos.max()) > max_hits:
            raise ValueError(
                f"a shard has {int(n_hit_pos.max())} matching positions, "
                f"over max_hits_per_shard={max_hits}")
        positions = np.asarray(positions).reshape(-1)
        sts = np.asarray(sts).reshape(-1)
        keep = (positions >= 0) & (positions < T)
        positions, sts = positions[keep], sts[keep]
        order_p = np.argsort(positions, kind="stable")
        ends, end_states, idx_out = expand_hits_arrays(
            positions[order_p], sts[order_p], self.tables, offset)
        return MatchSet(self.machine, self.tables, ends, end_states,
                        idx_out)

    def _sparse_hits(self, ids: np.ndarray, offset, head, max_hits):
        """Sharded filter-then-extract retrieval: the mesh sibling of
        DenseScanner._sparse_hits (host filter per shard, dense-table
        windows, bounded hit buffers all_gathered). Returns None when not
        profitable/applicable — caller falls through to the dense
        sharded bounded-hits kernel. ``max_hits=None`` = AUTO: per-shard
        buffers size to cap * L_blk (cap covers the busiest shard's live
        blocks), so overflow is structural and the raise is skipped."""
        from ..models.results import MatchSet
        from ..ops import sparse
        from ..ops.decode import expand_hits_arrays
        halo = self.halo
        L_blk = 128
        if halo > L_blk:
            return None
        T = len(ids)
        nB_real = -(-T // L_blk)
        nB_min = max(1, -(-T // (self.n_dev * L_blk)))
        nB_loc = 1 << (nB_min - 1).bit_length()
        Tp = self.n_dev * nB_loc * L_blk
        if Tp != T:
            ids = np.concatenate([ids, np.zeros(Tp - T, np.int32)])
        live = sparse.live_blocks(ids, L_blk).reshape(self.n_dev, nB_loc)
        n_live = live.sum(axis=1)
        total_live = int(n_live.sum())
        self.stats["sparse_live_frac"] = total_live / max(nB_real, 1)
        if total_live == 0:
            return MatchSet(self.machine, self.tables,
                            np.zeros(0, np.int64), np.zeros(0, np.int32),
                            np.zeros(0, np.int32))
        if self._prefilter == "auto" and total_live * 2 > nB_real:
            return None
        cap = max(8, 1 << (int(n_live.max()) - 1).bit_length())
        auto = max_hits is None
        if auto:
            # Structural per-shard bound: every hit lies in a live block.
            max_hits = cap * L_blk
        idx = np.full((self.n_dev, cap), nB_loc, np.int32)
        for d in range(self.n_dev):
            w = np.flatnonzero(live[d])
            idx[d, :len(w)] = w
        placed_ids = jax.device_put(np.ascontiguousarray(ids), self._shard)
        placed_idx = jax.device_put(idx.reshape(-1), self._shard)
        fn = make_sharded_sparse_hits(self.mesh, self.V, halo, L_blk,
                                      nB_loc, cap, max_hits,
                                      self.axis_name)
        positions, sts, n_hit_pos = fn(self._dflat, self._nb_out,
                                       placed_ids, placed_idx,
                                       head=self._head_arr(head, halo))
        n_hit_pos = np.asarray(n_hit_pos)
        if not auto and int(n_hit_pos.max()) > max_hits:
            raise ValueError(
                f"a shard has {int(n_hit_pos.max())} matching positions, "
                f"over max_hits_per_shard={max_hits}")
        positions = np.asarray(positions).reshape(-1)
        sts = np.asarray(sts).reshape(-1)
        keep = (positions >= 0) & (positions < T)
        positions, sts = positions[keep], sts[keep]
        order = np.argsort(positions, kind="stable")
        ends, end_states, idx_out = expand_hits_arrays(
            positions[order], sts[order], self.tables, offset)
        return MatchSet(self.machine, self.tables, ends, end_states,
                        idx_out)
