"""k-char stepped scan tables: one gather advances k symbols.

Each scan step is one data-dependent gather per stream, so the lever on
throughput is *gathers per byte*:

1. pack (next_state, match_count) into a single int32 word — halves gathers
   vs separate delta/nb_outputs lookups;
2. precompose the transition table over k-grams:
       delta_k[s, (c_1..c_k)] = delta[...delta[s, c_1]..., c_k]
       cnt_k[s, (c_1..c_k)]   = sum_j nb_out(state after c_j)
   so one gather advances k symbols and accounts *all* intermediate match
   counts (the count at every position is preserved exactly — nothing is
   skipped, matching acm_match's per-symbol totals, ref c:433-448).

Table size is S * V^k words; k is chosen automatically as the largest value
fitting a memory budget. The count path uses these; the per-position *states*
path (needed for match decoding) stays 1-char.

Packing layout: value = (next_state << count_bits) | step_count, with
count_bits sized from the actual maximum k-gram count at build time. If
state_bits + count_bits exceed 31, falls back to two unpacked int32 tables
(2 gathers per k symbols) — int64 packing would require global x64 mode.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..core.builder import DenseTables, round_cap  # noqa: F401 (re-export)


@dataclass
class SteppedTables:
    k: int                      # symbols per gather
    V: int                      # base vocab size
    count_bits: int             # 0 when unpacked
    packed: Optional[np.ndarray]        # int32 [S * V^k] or None
    delta_k: Optional[np.ndarray]       # int32 [S * V^k] when unpacked
    cnt_k: Optional[np.ndarray]         # int32 [S * V^k] when unpacked
    # capacity-padded calloc'd backing buffer of ``packed`` (first S*Vk
    # entries are the table; tail rows stay virtual zero pages) — set when
    # build_stepped was called with cap_rows, so DeviceSnapshot can use it
    # as its host mirror outright instead of re-allocating + copying the
    # (potentially multi-hundred-MB) packed table
    cap_packed: Optional[np.ndarray] = None

    @property
    def Vk(self) -> int:
        return self.V ** self.k


def choose_k(n_states: int, vocab_size: int, budget_bytes: int,
             max_k: int = 4) -> int:
    """Largest k with S * V^k * 4 (or 8 unpacked) within budget."""
    k = 1
    for cand in range(2, max_k + 1):
        if n_states * (vocab_size ** cand) * 4 <= budget_bytes:
            k = cand
    return k


def compose_rows(delta: np.ndarray, nb: np.ndarray, rows: np.ndarray,
                 k: int) -> tuple:
    """k-gram composition restricted to a subset of state rows.

    Returns (d [R, V^k] int32 landing states, cnt [R, V^k] int64 summed
    match counts). Row s of the full stepped table depends only on
    delta[s, :] and on delta/nb of states within k forward steps of s, so
    an incremental refresh (models/scanner.py:DenseScanner.refresh) can
    recompute exactly the affected rows with this."""
    R = len(rows)
    d = delta[rows]                          # [R, V]
    cnt = nb[d].astype(np.int64)
    for _ in range(k - 1):
        d2 = delta[d]                        # [R, G, V]
        cnt = (cnt[..., None] + nb[d2]).reshape(R, -1)
        d = d2.reshape(R, -1)
    return d, cnt


def stepped_delta_cells(old: DenseTables, new: DenseTables, k: int):
    """Exact changed-cell set of the k-gram stepped table between snapshots.

    Row-level invalidation is useless here: fail-collapsed rows are globally
    coupled (every state's row lands in shallow states, so one new trie edge
    on a depth-1/2 state "dirties" every row) — but only a few CELLS per row
    actually change (the grams routed through the changed edge). The
    dependency structure:

        stepped[s, c_1..c_k] depends on the hop cells delta[m_{i-1}, c_i]
        and the hop counts nb[m_i] along m_0 = s, m_i = delta[m_{i-1}, c_i].

    dirty_j[m, g] marks j-gram tails from m whose value changed; it is built
    bottom-up with dirty_1 = cell-diff | nb-diff of the landing state, and
    dirty_{j+1}[m, c.g] = dirty_1[m, c] | dirty_j[delta[m,c], g]. The last
    level is enumerated SPARSELY — per (s, c_1) pair, either all V^{k-1}
    tails (own hop dirty) or the changed-tail list of the landing state — so
    the cost is O(S*V + output cells), not O(S*V^k) (this is the refresh
    latency floor for serving; see bench_refresh.py).

    Returns (cells, land, cnt): flat int32 indices into the [S_new * V^k]
    stepped table, the recomputed landing states, and the recomputed int64
    k-gram counts. Used by models/snapshot.py:DeviceSnapshot.refresh to
    scatter an online insertion into the device table without a rebuild."""
    assert k >= 1
    S_old = old.n_states
    delta, nb = new.delta, new.nb_outputs
    S_new, V = delta.shape
    dirty1 = np.ones((S_new, V), dtype=bool)
    np.not_equal(old.delta, delta[:S_old], out=dirty1[:S_old])
    nbD = np.ones(S_new, dtype=bool)
    np.not_equal(old.nb_outputs, nb[:S_old], out=nbD[:S_old])
    dirty1 |= nbD[delta]
    if k == 1:
        # 1-gram: a cell changes iff its hop cell or the landing state's
        # count changed — dirty1 IS the changed-cell set.
        sp, cp = np.nonzero(dirty1)
        cells = (sp.astype(np.int64) * V + cp).astype(np.int32)
        land = delta[sp, cp].astype(np.int32)
        return cells, land, nb[land].astype(np.int64)
    # Tail levels below the top stay dense: G = V^(k-1) entries per state,
    # only reached for k >= 3 where the budget already bounds S*V^(k-1).
    dirty = dirty1
    for _ in range(k - 2):
        G = dirty.shape[1]
        dirty = (dirty1[:, :, None] | dirty[delta]).reshape(S_new, V * G)
    G = dirty.shape[1]
    Vk = V * G

    # -- sparse top level ---------------------------------------------------
    t_cnt = dirty.sum(axis=1, dtype=np.int64)            # changed tails per state
    sp, cp = np.nonzero(dirty1 | (t_cnt[delta] > 0))     # contributing pairs
    if not len(sp):
        z = np.zeros(0, np.int32)
        return z, z, np.zeros(0, np.int64)
    mp = delta[sp, cp]
    full = dirty1[sp, cp]                                # own hop dirty -> all G
    cnts = np.where(full, G, t_cnt[mp])
    offs = np.cumsum(cnts) - cnts                        # output start per pair
    total = int(cnts.sum())
    tails_out = np.empty(total, np.int64)

    fi = np.flatnonzero(full)
    if len(fi):
        idx = (offs[fi][:, None] + np.arange(G, dtype=np.int64)).reshape(-1)
        tails_out[idx] = np.tile(np.arange(G, dtype=np.int64), len(fi))

    si = np.flatnonzero(~full & (cnts > 0))
    if len(si):
        # CSR over the changed-tail lists of the (few) dirty states.
        changed_states = np.flatnonzero(t_cnt > 0)
        _, tails_vals = np.nonzero(dirty[changed_states])
        tails_start = np.concatenate(
            [[0], np.cumsum(t_cnt[changed_states])])[:-1]
        inv = np.full(S_new, -1, np.int64)
        inv[changed_states] = np.arange(len(changed_states))
        lens = cnts[si]
        src0 = tails_start[inv[mp[si]]]
        inner = (np.arange(int(lens.sum()), dtype=np.int64)
                 - np.repeat(np.cumsum(lens) - lens, lens))
        tails_out[np.repeat(offs[si], lens) + inner] = \
            tails_vals[np.repeat(src0, lens) + inner]

    srep = np.repeat(sp.astype(np.int64), cnts)
    grep = np.repeat(cp.astype(np.int64), cnts) * G + tails_out
    cells = (srep * Vk + grep).astype(np.int32)

    # -- recompute the cell values by walking the gram digits ---------------
    m = srep
    cnt = np.zeros(len(srep), np.int64)
    for i in range(k):
        c = grep // (V ** (k - 1 - i)) % V
        m = delta[m, c]
        cnt += nb[m]
    return cells, m.astype(np.int32), cnt


def build_stepped(tables: DenseTables, k: int,
                  cap_rows: Optional[int] = None) -> SteppedTables:
    """Compose delta/nb_outputs over k-grams and pack. ``cap_rows``: also
    allocate the packed table inside a [cap_rows * V^k] calloc'd capacity
    buffer (returned as ``cap_packed``) for zero-copy snapshot adoption."""
    delta = tables.delta                     # [S, V]
    nb = tables.nb_outputs
    S, V = delta.shape
    # Exact max k-gram count by DP over tail lengths (O(S*V*k)):
    #   h_j[m] = max_c (nb[delta[m,c]] + h_{j-1}[delta[m,c]]), h_0 = 0,
    # so the O(S*V^k) int64 count intermediate is never materialized on
    # the packed path.
    h = np.zeros(S, np.int64)
    for _ in range(k):
        h = (nb[delta] + h[delta]).max(axis=1)
    max_cnt = int(h.max()) if S else 0
    count_bits = max(1, int(max_cnt).bit_length()) if max_cnt else 1
    state_bits = max(1, int(S - 1).bit_length())
    # Headroom (up to 3 bits = 8x count growth, plus room for the state
    # capacity padding) so incremental refreshes (scanner.refresh) rarely
    # hit the count-width fallback when online insertions raise a count.
    grow_bits = max(1, int(round_cap(S) - 1).bit_length())
    count_bits = max(count_bits,
                     min(count_bits + 3, 31 - max(state_bits, grow_bits)))
    if state_bits + count_bits <= 31:
        cap_buf = (np.zeros(cap_rows * V ** k, np.int32)
                   if cap_rows is not None and cap_rows >= S else None)
        try:
            # Threaded native compose+pack (native/acx.cpp) — one pass,
            # no intermediates. Falls back to numpy when the native core
            # is unavailable (the numpy path is also the test oracle).
            from ..core.native import compose_pack
            packed = compose_pack(delta, nb, k, count_bits, out=cap_buf)
        except Exception:
            d, cnt = compose_rows(delta, nb, np.arange(S, dtype=np.int64), k)
            packed = (((d.astype(np.int64) << count_bits) | cnt)
                      .astype(np.int32).reshape(-1))
            if cap_buf is not None:
                cap_buf[:packed.size] = packed
                packed = cap_buf[:packed.size]
        return SteppedTables(k=k, V=V, count_bits=count_bits,
                             packed=packed, delta_k=None, cnt_k=None,
                             cap_packed=cap_buf)
    d, cnt = compose_rows(delta, nb, np.arange(S, dtype=np.int64), k)
    return SteppedTables(k=k, V=V, count_bits=0, packed=None,
                         delta_k=d.reshape(-1).astype(np.int32),
                         cnt_k=cnt.reshape(-1).astype(np.int32))


def combine_grams(ids_tm, V: int, k: int):
    """[L, B] symbol ids -> [L/k, B] k-gram ids (L % k == 0).

    Elementwise VPU work, fused into the same jit as the scan."""
    L = ids_tm.shape[0]
    g = ids_tm[0::k]
    for j in range(1, k):
        g = g * V + ids_tm[j::k]
    return g


def stepped_count_core(V: int, k: int, Vk: int, count_bits: int,
                       halo_steps: int, packed, ids_tm):
    """Traced body shared by the jitted single-chip stepped count and the
    shard_map per-device stepped count."""
    mask = (1 << count_bits) - 1
    grams = combine_grams(ids_tm, V, k)          # [Lk, B]
    Lk = grams.shape[0]
    s0 = grams[0] * 0
    zero = grams[0] * 0

    def step(carry, tg):
        t, g = tg
        s, tot = carry
        v = packed[s * Vk + g]
        s2 = v >> count_bits
        cnt = jnp.where(t >= halo_steps, v & mask, 0)
        return (s2, tot + cnt), None

    ts = jnp.arange(Lk, dtype=jnp.int32)
    (_, tot), _ = lax.scan(step, (s0, zero), (ts, grams))
    return tot  # per-stream totals; see blocked_count_core


@lru_cache(maxsize=None)
def make_stepped_count(V: int, k: int, Vk: int, count_bits: int,
                       halo_steps: int):
    """Returns jitted count(packed, ids_tm) -> total (packed variant).

    ids_tm: [L, B] symbol ids with L % k == 0 and the first
    halo_steps * k rows being warm-up halo (excluded from the count)."""

    @jax.jit
    def count(packed, ids_tm):
        return stepped_count_core(V, k, Vk, count_bits, halo_steps,
                                  packed, ids_tm)

    return count


@lru_cache(maxsize=None)
def make_stepped_count_stream(V: int, k: int, Vk: int, count_bits: int,
                              halo_steps: int, B: int, L: int):
    """Stream-input packed count: ext [halo_steps*k + B*L] contiguous ids
    with the left halo prepended; window layout runs ON DEVICE (see
    scan_xla.make_blocked_count_stream for why the host layout was the
    end-to-end bottleneck). L % k == 0."""
    from .scan_xla import window_layout

    @jax.jit
    def count(packed, ext):
        win = window_layout(ext, B, L, halo_steps * k)
        return stepped_count_core(V, k, Vk, count_bits, halo_steps,
                                  packed, win)

    return count


@lru_cache(maxsize=None)
def make_stepped_count_raw(V: int, k: int, Vk: int, count_bits: int,
                           halo_steps: int, B: int, L: int):
    """Raw-input packed count: the vocab encode rides inside the jit
    (scan_xla.raw_window staging contract). L % k == 0."""
    from .scan_xla import raw_window

    @jax.jit
    def count(packed, lut, ext_raw, head_ids):
        win = raw_window(lut, ext_raw, head_ids, B, L, halo_steps * k)
        return stepped_count_core(V, k, Vk, count_bits, halo_steps,
                                  packed, win)

    return count


def _stepped_count_many_body(V, k, Vk, count_bits, halo_steps, c, Lp,
                             packed, w):
    """Shared batched-count trace: optional per-document split (Lp and
    the halo are k-multiples so gram boundaries align) and the combine
    back to per-document totals [B]."""
    from .scan_xla import split_docs_layout
    if c > 1:
        B = w.shape[1]
        w = split_docs_layout(w, c, Lp, halo_steps * k)
        per = stepped_count_core(V, k, Vk, count_bits, halo_steps,
                                 packed, w)
        return per.reshape(c, B).sum(axis=0)
    return stepped_count_core(V, k, Vk, count_bits, 0, packed, w)


@lru_cache(maxsize=None)
def make_stepped_count_many(V: int, k: int, Vk: int, count_bits: int,
                            halo_steps: int, c: int, Lp: int,
                            raw: bool = False):
    """Batched per-document count through the packed k-gram table
    (round 5, VERDICT r4 #6): tm [L, B] symbols, one document per column
    starting at the root, tail-padded with 0 (raw 0 == OOV by the
    raw_lut_entry contract). ``raw``: the vocab encode rides inside the
    jit per column — byte batches ship 1 byte/symbol, 4x less wire.
    ``c > 1``: split every document into c blocks of Lp symbols with
    halo warm-up (split_docs_layout) — the sequential chain shrinks c x,
    so small batches of long documents reach stream-kernel parallelism.
    L % k == 0. Reference anchor: one-cursor-per-stream scoring,
    c:433-448."""

    if raw:
        @jax.jit
        def count(packed, lut, tm):
            return _stepped_count_many_body(
                V, k, Vk, count_bits, halo_steps, c, Lp, packed,
                lut[tm.astype(jnp.int32)])
    else:
        @jax.jit
        def count(packed, tm):
            return _stepped_count_many_body(
                V, k, Vk, count_bits, halo_steps, c, Lp, packed, tm)

    return count


@lru_cache(maxsize=None)
def make_stepped_count_unpacked_stream(V: int, k: int, Vk: int,
                                       halo_steps: int, B: int, L: int):
    """Stream-input unpacked (two-table) count."""
    from .scan_xla import window_layout

    @jax.jit
    def count(delta_k, cnt_k, ext):
        win = window_layout(ext, B, L, halo_steps * k)
        grams = combine_grams(win, V, k)
        Lk = grams.shape[0]
        s0 = grams[0] * 0
        zero = grams[0] * 0

        def step(carry, tg):
            t, g = tg
            s, tot = carry
            i = s * Vk + g
            s2 = delta_k[i]
            cnt = jnp.where(t >= halo_steps, cnt_k[i], 0)
            return (s2, tot + cnt), None

        ts = jnp.arange(Lk, dtype=jnp.int32)
        (_, tot), _ = lax.scan(step, (s0, zero), (ts, grams))
        return tot

    return count


@lru_cache(maxsize=None)
def make_stepped_count_unpacked(V: int, k: int, Vk: int, halo_steps: int):
    """Two-table fallback when (state, count) exceed 31 packed bits."""

    @jax.jit
    def count(delta_k, cnt_k, ids_tm):
        grams = combine_grams(ids_tm, V, k)
        Lk = grams.shape[0]
        s0 = grams[0] * 0
        zero = grams[0] * 0

        def step(carry, tg):
            t, g = tg
            s, tot = carry
            i = s * Vk + g
            s2 = delta_k[i]
            cnt = jnp.where(t >= halo_steps, cnt_k[i], 0)
            return (s2, tot + cnt), None

        ts = jnp.arange(Lk, dtype=jnp.int32)
        (_, tot), _ = lax.scan(step, (s0, zero), (ts, grams))
        return tot  # per-stream totals; sum on host in int64

    return count
