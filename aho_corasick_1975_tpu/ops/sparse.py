"""Hybrid filter-then-verify scanning for low-match-density corpora.

The reference walks every input symbol through state_goto
(/root/reference/aho_corasick.c:167-192, 433-448) — O(1) per symbol no
matter how little of the corpus can possibly match. On the device the
automaton scan is bound by one dependent gather per step, while a
"can this region match at all?" test is pure bandwidth. This module
exploits the vocabulary's OOV contract to skip the automaton over the
dead parts of the corpus EXACTLY:

* Vocab id 0 = OOV = "appears in no keyword" (utils/vocab.py:15). By
  fail-collapse, delta[s, 0] == root for EVERY state s, and the root
  never emits (empty keywords are rejected). Therefore
    - no match ends inside an all-OOV region, and
    - the automaton state at the first symbol AFTER an all-OOV block is
      exactly the root.

* Cut the stream into fixed blocks of ``L_blk`` symbols. Only blocks
  containing a non-OOV symbol ("live" blocks) can contribute counts.
  Each live block is scanned as one stream column of the standard
  halo-windowed blocked kernel: its window is [the ``halo`` symbols
  that precede it in the ORIGINAL stream] + [its L_blk symbols], and
  warm-up counts are suppressed — the ordinary sequence-parallel
  blocking argument (ops/blocking.py) applied to a subset of blocks.
  Dead blocks need no window at all: their own positions emit nothing,
  and a live block following a dead one warms up from root over zeros.

The filter (per-block any-non-OOV) runs on the host in one vectorized
numpy pass over the already-encoded ids — far above the device scan
rate — and decides the gather index list; the device then gathers ONLY
the live windows (two row gathers, ~0.5-1 KB per row) and runs the same
packed k-gram (or dense) count core as the dense path. Effective
throughput scales as 1/density: a corpus where 1% of blocks are live
scans ~30-60x faster than the dense kernel (benchmarks/bench_sparse.py).
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["live_blocks", "make_sparse_count", "make_sparse_count_stepped",
           "make_sparse_count_mxu", "make_sparse_hits"]


def live_blocks(ids: np.ndarray, L_blk: int) -> np.ndarray:
    """Host filter pass: bool[ceil(T/L_blk)] — block contains a non-OOV id.
    Letter ids are non-negative, so a row-max reduce is the fastest exact
    formulation (`(!=0).any(axis=1)` materializes a bool temp). The tail block is judged on its real
    symbols only (padding is OOV and therefore dead)."""
    T = len(ids)
    nB = -(-T // L_blk)
    if nB * L_blk != T:
        ids = np.concatenate([ids, np.zeros(nB * L_blk - T, np.int32)])
    return ids.reshape(nB, L_blk).max(axis=1) != 0


def elide_windows(arr: np.ndarray, lut, T: int, live: np.ndarray,
                  n_live: int, head, halo: int, L_blk: int, nB_real: int,
                  pad_cols_to: int = 1):
    """HOST-side dead-block elision (round 4): gather the live blocks'
    halo windows directly from the symbol array — no full-length staging
    buffer (at GB scale the zeros+copy alone dominated on slow-first-touch
    hosts) — translating through the host LUT when ``arr`` is raw.
    Returns (tm, idx): the [halo + L_blk, cap] time-major windows to
    upload (cap a pow2 bucket of n_live, rounded up to ``pad_cols_to``)
    and the int64 [cap] block indices (pad columns point at the spare
    all-OOV block nB_real, whose positions land past the stream end);
    wire bytes = live fraction x corpus. Exact by the OOV-resets-to-root contract:
    windows replay the original stream (block b's halo is its true
    preceding symbols), out-of-range positions are OOV, and warm-up rows
    never count. ``head``: ID-space session carry for block 0's halo."""
    cap = max(8, 1 << (n_live - 1).bit_length())
    cap = -(-cap // pad_cols_to) * pad_cols_to
    idx = np.full(cap, nB_real, np.int64)       # pad -> spare dead block
    idx[:n_live] = np.flatnonzero(live)
    cols = np.arange(-halo, L_blk, dtype=np.int64)
    pos = idx[:, None] * L_blk + cols[None, :]
    safe = np.clip(pos, 0, max(T - 1, 0))
    win = arr[safe]
    if lut is not None:
        lut_host, n_lut = lut
        if win.dtype == np.uint8 and n_lut >= 256:
            win = lut_host[win]
        else:
            win = lut_host[np.minimum(win.astype(np.int64, copy=False),
                                      n_lut - 1)]
    else:
        win = win.astype(np.int32, copy=False)
    win[(pos < 0) | (pos >= T)] = 0
    if halo:
        r0 = np.flatnonzero(idx == 0)
        if r0.size:
            hrow = np.zeros(halo, np.int32)
            if head is not None and len(head):
                hh = min(len(head), halo)
                hrow[halo - hh:] = np.asarray(head, np.int32)[-hh:]
            win[r0[0], :halo] = hrow
    return np.ascontiguousarray(win.T), idx


def raw_live_blocks(raw: np.ndarray, lut_host: np.ndarray, n_lut: int,
                    L_blk: int):
    """Live-block filter over RAW symbols through the host LUT (live iff
    any symbol's ID is non-OOV — exactly the id-path filter; the LUT is
    the id map, pre-masked to the snapshot). Byte corpora take a uint8
    bool-LUT gather writing at most 1 byte/symbol: the int64 clamp
    formulation allocates GBs of temporaries, and slow-first-touch hosts
    pay for every fresh page. Returns (live bool[nB],
    nB_real)."""
    T = len(raw)
    nB_real = -(-T // L_blk)
    if raw.dtype == np.uint8 and n_lut >= 256:
        lv = (lut_host != 0).astype(np.uint8)[raw]
    else:
        lv = (lut_host[np.minimum(raw.astype(np.int64, copy=False),
                                  n_lut - 1)] != 0).astype(np.uint8)
    pad = nB_real * L_blk - T
    if pad:
        lv = np.concatenate([lv, np.zeros(pad, np.uint8)])
    return lv.reshape(nB_real, L_blk).max(axis=1).astype(bool), nB_real


def raw_elision_plan(raw: np.ndarray, lut_host: np.ndarray, n_lut: int,
                     prefilter: str, halo: int, L_blk: int):
    """The elision DECISION, shared by DenseScanner and ShardedScanner
    (one copy of the policy — review r4): run the raw live-block filter
    and classify the corpus. Returns (verdict, live, n_live, nB_real)
    with verdict one of:

    * "zero"  — no live block: the count is exactly 0, no device work;
    * "dense" — the "auto" gate measured a match-dense corpus: take the
      dense raw engines directly, do NOT re-filter on the id path;
    * "na"    — elision not applicable/profitable here (halo wider than
      a block, or live windows over half the stream): the id-path sparse
      kernels decide;
    * "elide" — gather/encode/upload only the live windows
      (elide_windows)."""
    if halo > L_blk:
        return "na", None, 0, 0
    live, nB_real = raw_live_blocks(raw, lut_host, n_lut, L_blk)
    n_live = int(live.sum())
    if n_live == 0:
        return "zero", live, 0, nB_real
    if prefilter == "auto" and n_live * 2 > nB_real:
        return "dense", live, n_live, nB_real
    if n_live * (halo + L_blk) * 2 >= max(len(raw), 1):
        return "na", live, n_live, nB_real
    return "elide", live, n_live, nB_real


def _window_gather(ext, idx, nB: int, L_blk: int, halo: int):
    """Gather live-block windows: ext [halo + (nB+1)*L_blk] (head halo in
    front, one all-OOV spare block at the end for padding columns),
    idx [cap] int32 block indices (pad slots point at the spare block nB).
    Returns [halo + L_blk, cap] time-major symbol windows."""
    body2d = ext[halo:].reshape(nB + 1, L_blk)
    # halo of block b = ext[b*L_blk : b*L_blk + halo]; with halo <= L_blk
    # these are the leading columns of the unshifted reshape.
    halo2d = ext[:(nB + 1) * L_blk].reshape(nB + 1, L_blk)[:, :halo]
    win = jnp.concatenate([halo2d[idx], body2d[idx]], axis=1)  # [cap, h+L]
    return win.T


@lru_cache(maxsize=None)
def make_sparse_count(V: int, halo: int, L_blk: int, nB: int, cap: int):
    """Dense-table sparse count: (dflat, nb_out, ext, idx) -> per-window
    int32 totals [cap]. ext/idx contract in _window_gather."""
    from .scan_xla import blocked_count_core

    @jax.jit
    def count(dflat, nb_out, ext, idx):
        win = _window_gather(ext, idx, nB, L_blk, halo)
        return blocked_count_core(V, halo, dflat, nb_out, win)

    return count


@lru_cache(maxsize=None)
def make_sparse_count_mxu(V: int, S_pad: int, count_bits: int,
                          n_planes: int, halo: int, L_blk: int, nB: int,
                          cap: int):
    """Sparse count through the MXU digit-matmul engine (small automata,
    ops/scan_mxu.py) — the two fast paths compose."""
    from .scan_mxu import mxu_count_core

    @jax.jit
    def count(planes, ext, idx):
        win = _window_gather(ext, idx, nB, L_blk, halo)
        return mxu_count_core(V, S_pad, count_bits, n_planes, halo,
                              planes, win)

    return count


def _window_hits_core(V: int, halo: int, L_blk: int, max_hits: int,
                      dflat, nb_out, win, idx):
    """Bounded hit extraction over live-block windows: win
    [halo + L_blk, cap] symbol ids, idx [cap] block indices (stream
    position of window cell (t, col) = idx[col]*L_blk + t). Shared by the
    device-gather sparse hits and the host-elided variant."""
    from jax import lax

    s0 = jnp.zeros((win.shape[1],), dtype=jnp.int32)

    def step(s, c):
        s2 = dflat[s * V + c]
        return s2, s2

    _, states_tm = lax.scan(step, s0, win)           # [halo+L_blk, cap]
    counts = nb_out[states_tm][halo:, :]             # [L_blk, cap]
    hit_mask = counts > 0
    n_hits = jnp.sum(counts, dtype=jnp.int32)
    n_hit_pos = jnp.sum(hit_mask, dtype=jnp.int32)
    pos2d = (idx[None, :] * L_blk
             + jnp.arange(L_blk, dtype=jnp.int32)[:, None])
    (flat_idx,) = jnp.nonzero(hit_mask.T.reshape(-1), size=max_hits,
                              fill_value=-1)
    valid = flat_idx >= 0
    safe = jnp.maximum(flat_idx, 0)
    positions = jnp.where(valid, pos2d.T.reshape(-1)[safe], -1)
    sts = jnp.where(valid, states_tm[halo:, :].T.reshape(-1)[safe], 0)
    return positions, sts, n_hits, n_hit_pos


@lru_cache(maxsize=None)
def make_sparse_hits(V: int, halo: int, L_blk: int, nB: int, cap: int,
                     max_hits: int):
    """Filter-then-EXTRACT: bounded hit positions/states over the live
    windows only (the sparse companion of ops/hits.make_blocked_hits).
    (dflat, nb_out, ext, idx) -> (positions[max_hits] stream-order indices
    (-1 pad), states[max_hits], n_hits total matches, n_hit_pos matching
    positions). idx ascending keeps the nonzero output in stream order.
    Uses the dense delta table: hit extraction needs per-position states,
    which the packed k-gram and MXU cores do not materialize."""

    @jax.jit
    def hits(dflat, nb_out, ext, idx):
        win = _window_gather(ext, idx, nB, L_blk, halo)  # [halo+L_blk, cap]
        return _window_hits_core(V, halo, L_blk, max_hits, dflat, nb_out,
                                 win, idx)

    return hits


@lru_cache(maxsize=None)
def make_elided_hits(V: int, halo: int, L_blk: int, max_hits: int):
    """Bounded hits over HOST-ELIDED windows (elide_windows output): only
    the live windows were uploaded — wire bytes = live fraction x corpus,
    the retrieval sibling of the elided count. (dflat, nb_out, tm, idx)
    with tm [halo + L_blk, cap]; pad columns must carry idx pointing past
    the last real block so their positions filter out as >= T."""

    @jax.jit
    def hits(dflat, nb_out, tm, idx):
        return _window_hits_core(V, halo, L_blk, max_hits, dflat, nb_out,
                                 tm, idx)

    return hits


# -- device-side block filter (no host pass, no index upload) --------------


@lru_cache(maxsize=None)
def make_block_filter(nB: int, L_blk: int, halo: int):
    """Live-block filter ON DEVICE: ext [halo + (nB+1)*L_blk] ->
    (order [nB] int32 — live block indices first, stream order preserved,
    dead blocks after; n_live int32). The caller syncs only the 4-byte
    n_live (to pick the pow2 gather capacity); the order array stays
    device-resident and feeds the *_dev sparse kernels directly. This
    removes the host bandwidth pass and the index upload of the host
    filter (live_blocks), and lets device-resident corpora skip the host
    entirely (VERDICT r2 item 4)."""

    @jax.jit
    def filt(ext):
        body = ext[halo:halo + nB * L_blk].reshape(nB, L_blk)
        live = body.max(axis=1) > 0
        n_live = jnp.sum(live, dtype=jnp.int32)
        order = jnp.argsort(jnp.logical_not(live),
                            stable=True).astype(jnp.int32)
        return order, n_live

    return filt


def _dev_idx(order, n_live, nB: int, cap: int):
    """First cap entries of the device-computed order, padded to the spare
    all-OOV block nB beyond the live count."""
    sel = order[:cap]
    return jnp.where(jnp.arange(cap, dtype=jnp.int32) < n_live, sel, nB)


@lru_cache(maxsize=None)
def make_sparse_count_dev(V: int, halo: int, L_blk: int, nB: int, cap: int):
    """Dense-table sparse count with a DEVICE-resident index order
    (make_block_filter output): (dflat, nb_out, ext, order, n_live)."""
    from .scan_xla import blocked_count_core

    @jax.jit
    def count(dflat, nb_out, ext, order, n_live):
        win = _window_gather(ext, _dev_idx(order, n_live, nB, cap),
                             nB, L_blk, halo)
        return blocked_count_core(V, halo, dflat, nb_out, win)

    return count


@lru_cache(maxsize=None)
def make_sparse_count_stepped_dev(V: int, k: int, Vk: int, count_bits: int,
                                  halo_steps: int, L_blk: int, nB: int,
                                  cap: int):
    """Packed k-gram sparse count, device-resident index order."""
    from .multistep import stepped_count_core

    halo = halo_steps * k

    @jax.jit
    def count(packed, ext, order, n_live):
        win = _window_gather(ext, _dev_idx(order, n_live, nB, cap),
                             nB, L_blk, halo)
        return stepped_count_core(V, k, Vk, count_bits, halo_steps,
                                  packed, win)

    return count


@lru_cache(maxsize=None)
def make_sparse_count_mxu_dev(V: int, S_pad: int, count_bits: int,
                              n_planes: int, halo: int, L_blk: int,
                              nB: int, cap: int):
    """MXU sparse count, device-resident index order."""
    from .scan_mxu import mxu_count_core

    @jax.jit
    def count(planes, ext, order, n_live):
        win = _window_gather(ext, _dev_idx(order, n_live, nB, cap),
                             nB, L_blk, halo)
        return mxu_count_core(V, S_pad, count_bits, n_planes, halo,
                              planes, win)

    return count


@lru_cache(maxsize=None)
def make_sparse_hits_dev(V: int, halo: int, L_blk: int, nB: int, cap: int,
                         max_hits: int):
    """Filter-then-EXTRACT with a DEVICE-resident index order (round 5,
    VERDICT r4 #3): retrieval for corpora pinned in HBM — the block
    filter (make_block_filter) ran on device, the caller synced only the
    4-byte n_live to pick ``cap``/``max_hits`` pow2 buckets, and this
    kernel gathers + scans only the live windows and returns bounded hit
    positions/states with zero per-call corpus upload.
    (dflat, nb_out, ext, order, n_live) -> same contract as
    make_sparse_hits. Reference anchor: acm_get_match,
    /root/reference/aho_corasick.c:450-482."""

    @jax.jit
    def hits(dflat, nb_out, ext, order, n_live):
        idx = _dev_idx(order, n_live, nB, cap)
        win = _window_gather(ext, idx, nB, L_blk, halo)
        return _window_hits_core(V, halo, L_blk, max_hits, dflat, nb_out,
                                 win, idx)

    return hits


@lru_cache(maxsize=None)
def make_sparse_count_stepped(V: int, k: int, Vk: int, count_bits: int,
                              halo_steps: int, L_blk: int, nB: int,
                              cap: int):
    """Packed k-gram sparse count (the fast core; L_blk and the halo are
    multiples of k so gram boundaries align)."""
    from .multistep import stepped_count_core

    halo = halo_steps * k

    @jax.jit
    def count(packed, ext, idx):
        win = _window_gather(ext, idx, nB, L_blk, halo)
        return stepped_count_core(V, k, Vk, count_bits, halo_steps,
                                  packed, win)

    return count
