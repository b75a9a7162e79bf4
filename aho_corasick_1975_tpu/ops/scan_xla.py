"""XLA scan kernels: the automaton recurrence as gather chains.

The reference's per-symbol hot loop (state_goto, aho_corasick.c:167-192 —
ordered-map lookup + fail-chain walk) collapses here into a single gather per
symbol from the fail-collapsed dense table built by ``core/builder.py``:

    s' = delta[s, c]     (delta total: OOV and undefined transitions resolved)

Two layouts:

* ``sequential_*`` — one stream, one state: the literal recurrence. Simple,
  correct, but serial: it is the conformance oracle, not the fast path.
* ``blocked_*`` — B independent streams advanced in lockstep (time-major
  [L, B] input): each scan step gathers B transitions at once, turning the
  scalar chase into vector work for the VPU. Combined with halo overlap
  (``ops/blocking.py``) this parallelizes a single long stream on one chip,
  and is the per-device kernel of the sharded path (``parallel/``).

All functions close over the vocab width V and take the flattened table
``dflat = delta.reshape(-1)`` so the per-step index is one fused multiply-add.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
from jax import lax


@lru_cache(maxsize=None)
def make_sequential_scan(V: int):
    """Returns scan(dflat, ids, s0) -> (final_state, states[T]).

    states[t] is the automaton state *after* consuming ids[t] — the cursor
    the reference exposes after each acm_match call (c:447)."""

    @jax.jit
    def scan(dflat, ids, s0):
        def step(s, c):
            s2 = dflat[s * V + c]
            return s2, s2

        return lax.scan(step, s0, ids)

    return scan


@lru_cache(maxsize=None)
def make_blocked_scan(V: int):
    """Returns scan(dflat, ids_tm) -> states_tm.

    ids_tm: int32 [L, B] time-major block matrix (B streams, L steps each).
    All streams start at the root; halo semantics are the caller's concern
    (``ops/blocking.py`` proves root-start + halo re-run converges to the
    true state — the AC state is determined by the last max_depth symbols).
    """

    @jax.jit
    def scan(dflat, ids_tm):
        B = ids_tm.shape[1]
        s0 = jnp.zeros((B,), dtype=jnp.int32)

        def step(s, c):
            s2 = dflat[s * V + c]
            return s2, s2

        _, states = lax.scan(step, s0, ids_tm)
        return states

    return scan


def blocked_count_core(V: int, halo: int, dflat, nb_out, ids_tm):
    """Traced body shared by the jitted single-chip count and the shard_map
    per-device count: total matches over a [L, B] time-major block matrix,
    excluding the halo warm-up rows."""
    L, B = ids_tm.shape
    # Derive carry inits from the input so shard_map's varying-axis tracking
    # accepts the scan (a literal zeros const is device-invariant and cannot
    # carry a varying output).
    s0 = ids_tm[0] * 0
    zero = ids_tm[0] * 0

    def step(carry, tc):
        t, c = tc
        s, tot = carry
        s2 = dflat[s * V + c]
        cnt = jnp.where(t >= halo, nb_out[s2], 0)
        return (s2, tot + cnt), None

    ts = jnp.arange(L, dtype=jnp.int32)
    (_, tot), _ = lax.scan(step, (s0, zero), (ts, ids_tm))
    # per-stream totals (int32-safe: a stream holds < 2^31 matches); the
    # grand total is summed on the host in int64 by single-chip callers.
    return tot


def window_layout(ids_ext, n_blocks: int, block_len: int, halo: int):
    """In-graph equivalent of ops/blocking.block_time_major.

    ids_ext: [halo + n_blocks*block_len] stream with its left halo already
    prepended (zeros at the stream head, or the neighbor shard's tail on
    multi-chip). Returns the [halo+block_len, n_blocks] time-major windows.

    Implementation note: windows[t, b] = ids_ext[b*L + t]. The body rows
    (t >= halo) are just a reshape+transpose of the stream. The halo rows
    of window b are the last H symbols of window b-1, i.e. body rows
    [L-H:L] shifted one column right, with ids_ext's own head in column 0
    — a pure bandwidth-bound shuffle, not H stride-L slices."""
    H, L, B = halo, block_len, n_blocks
    body = ids_ext[H:].reshape(B, L).T                      # [L, B]
    if H == 0:
        return body
    if H <= L:
        halo_rows = jnp.concatenate(
            [ids_ext[:H][:, None], body[L - H:, :-1]], axis=1)   # [H, B]
    else:
        # halo longer than a block (tiny streams): fall back to strided
        # slices; cost is irrelevant at these sizes
        halo_rows = jnp.stack(
            [lax.slice(ids_ext, (t,), (t + (B - 1) * L + 1,), (L,))
             for t in range(H)], axis=0)
    return jnp.concatenate([halo_rows, body], axis=0)


def raw_window(lut, ext_raw, head_ids, B: int, L: int, halo: int):
    """Device-side encode fused into the window layout: ext_raw is RAW
    symbols (uint8 bytes or int32 codepoints, [halo + B*L], tail-padded
    with raw 0 — callers guarantee lut[0] == OOV), translated through the
    replicated LUT after windowing (1-byte layout traffic for byte
    corpora), with column 0's halo rows overwritten by head_ids (session
    carry in ID space — zeros for a stream head). This moves the whole
    vocab encode of utils/vocab.lookup_many into the scan jit: the only
    remaining host work per scan is one memcpy of the raw input."""
    win = lut[window_layout(ext_raw, B, L, halo)]
    if halo:
        win = lax.dynamic_update_slice(
            win, head_ids.astype(win.dtype)[:, None], (0, 0))
    return win


@lru_cache(maxsize=None)
def make_blocked_count_raw(V: int, halo: int, B: int, L: int):
    """Raw-input dense count: (dflat, nb_out, lut, ext_raw, head_ids) ->
    per-stream totals [B] int32. See raw_window for the staging contract."""

    @jax.jit
    def count(dflat, nb_out, lut, ext_raw, head_ids):
        win = raw_window(lut, ext_raw, head_ids, B, L, halo)
        return blocked_count_core(V, halo, dflat, nb_out, win)

    return count


@lru_cache(maxsize=None)
def make_blocked_scan_raw(V: int, halo: int, B: int, L: int):
    """Raw-input scan_states: states [B*L] out in stream order."""

    @jax.jit
    def scan(dflat, lut, ext_raw, head_ids):
        win = raw_window(lut, ext_raw, head_ids, B, L, halo)
        s0 = win[0] * 0

        def step(s, c):
            s2 = dflat[s * V + c]
            return s2, s2

        _, states_tm = lax.scan(step, s0, win)
        return states_tm[halo:, :].T.reshape(-1)

    return scan


@lru_cache(maxsize=None)
def make_blocked_count_stream(V: int, halo: int, B: int, L: int):
    """Stream-input count: takes ext [halo + B*L] (contiguous stream with
    its left halo prepended) and does the window layout ON DEVICE.

    The round-1 path laid out [halo+L, B] windows on the host — a
    cache-hostile 4-byte-strided transpose that dominated end-to-end
    time. window_layout on device is two HBM-bandwidth passes."""

    @jax.jit
    def count(dflat, nb_out, ext):
        win = window_layout(ext, B, L, halo)
        return blocked_count_core(V, halo, dflat, nb_out, win)

    return count


@lru_cache(maxsize=None)
def make_blocked_scan_stream(V: int, halo: int, B: int, L: int):
    """Stream-input scan_states: ext [halo + B*L] in, states [B*L] out in
    STREAM order (the unblock transpose also runs on device)."""

    @jax.jit
    def scan(dflat, ext):
        win = window_layout(ext, B, L, halo)
        s0 = win[0] * 0

        def step(s, c):
            s2 = dflat[s * V + c]
            return s2, s2

        _, states_tm = lax.scan(step, s0, win)
        return states_tm[halo:, :].T.reshape(-1)

    return scan


@lru_cache(maxsize=None)
def make_blocked_count(V: int, halo: int):
    """Returns count(dflat, nb_out, ids_tm) -> per-stream totals [B] int32.

    Positions t < halo of every stream are warm-up re-runs of the previous
    block's suffix and are excluded. Callers sum on the host in int64 (a
    single stream cannot overflow int32; a pod-scale grand total can)."""

    @jax.jit
    def count(dflat, nb_out, ids_tm):
        return blocked_count_core(V, halo, dflat, nb_out, ids_tm)

    return count  # returns per-stream totals; sum on host in int64


def split_docs_layout(tm, c: int, Lp: int, halo: int):
    """Per-document block splitting for batch scoring (round 5): [L, B]
    one-document-per-column -> [halo + Lp, c*B] where block i of doc j
    warms up from doc j's OWN preceding ``halo`` symbols (zeros before
    the doc head) — documents stay isolated, and the batch gains c x the
    sequential parallelism (the ops/blocking.py argument applied per
    column). Requires L <= c * Lp (rows past L read as OOV pad).
    Output column i*B + j = block i of doc j; callers sum groups of B."""
    L, B = tm.shape
    pad_rows = c * Lp - L
    padded = jnp.concatenate(
        [jnp.zeros((halo, B), tm.dtype), tm,
         jnp.zeros((pad_rows, B), tm.dtype)])     # [halo + c*Lp, B]
    blocks = [padded[i * Lp:i * Lp + halo + Lp, :] for i in range(c)]
    return jnp.concatenate(blocks, axis=1)        # [halo+Lp, c*B]


def _count_many_body(V, halo, c, Lp, dflat, nb_out, w):
    """Shared count_many trace: optional split, dense-table count, and
    the per-document combine back to [B]."""
    if c > 1:
        B = w.shape[1]
        w = split_docs_layout(w, c, Lp, halo)
        per = blocked_count_core(V, halo, dflat, nb_out, w)
        return per.reshape(c, B).sum(axis=0)
    return blocked_count_core(V, 0, dflat, nb_out, w)


@lru_cache(maxsize=None)
def make_blocked_count_many(V: int, halo: int, c: int, Lp: int,
                            raw: bool = False):
    """Batched per-document count through the dense table (round 5):
    tm [L, B] symbols, one document per column (root start, 0-padding
    inert — for raw inputs by the raw_lut_entry contract). ``raw``:
    encode through the replicated LUT inside the jit (1 byte/symbol on
    the wire for byte batches). ``c > 1``: split every document into c
    blocks of Lp via split_docs_layout — sequential chain shrinks c x."""

    if raw:
        @jax.jit
        def count(dflat, nb_out, lut, tm):
            return _count_many_body(V, halo, c, Lp, dflat, nb_out,
                                    lut[tm.astype(jnp.int32)])
    else:
        @jax.jit
        def count(dflat, nb_out, tm):
            return _count_many_body(V, halo, c, Lp, dflat, nb_out, tm)

    return count
