"""Capacity-padded device snapshot of the dense automaton tables.

Shared by the single-chip scanner (models/scanner.py) and the mesh scanner
(parallel/sharded_scan.py): owns the host mirrors, the device placement of
the 1-char tables and the optional k-gram stepped tables, and the
incremental cell-delta refresh that lets online Meyer insertions
(reference README.md:352-356) catch the device up without a rebuild.

Key design points (measured in benchmarks/bench_refresh.py):

* tables are allocated at ``round_cap`` state capacity (~12.5% headroom,
  never-read tail rows), so refreshes keep every array shape stable — XLA
  never recompiles a scan kernel because the dictionary grew;
* the stepped-table delta is extracted cell-exactly
  (ops/multistep.stepped_delta_cells) — row-level invalidation is useless
  because fail-collapsed rows couple globally through shallow states;
* scatters run in fixed-size chunks so each table width compiles exactly
  one XLA executable per process;
* vocabulary growth, packed-count-width overflow, capacity overflow, or a
  delta past ~25% of the table fall back to a transparent full rebuild.
"""

from __future__ import annotations

import time
from functools import lru_cache, partial
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.builder import DenseTables
from ..ops import multistep as ms


@lru_cache(maxsize=None)
def _make_row_scatter(width: int):
    """Jitted in-place row scatter on a flat table viewed as [cap, width].

    Row-level indices (R of them, not R*width element indices) keep the
    transfer and the device scatter cheap; the table buffer is donated, so
    XLA updates it in place (no 2x table footprint during a refresh)."""

    @partial(jax.jit, donate_argnums=(0,))
    def scatter(table, rows, vals):
        if width == 1:
            return table.at[rows].set(vals)
        return (table.reshape(-1, width).at[rows].set(vals)).reshape(-1)

    return scatter


class DeviceSnapshot:
    """Device-resident snapshot with in-place incremental refresh.

    ``place`` maps a host ndarray to a device array (default: local
    device; the mesh scanner passes a replicated ``device_put``).
    ``packed_only=True`` drops the stepped tables instead of using the
    two-table unpacked fallback (the sharded kernels only take packed).
    """

    def __init__(self, tables: DenseTables, step_k="auto",
                 step_budget_bytes: int = 128 * 1024 * 1024,
                 place: Optional[Callable] = None,
                 packed_only: bool = False):
        self._place = place if place is not None else jnp.asarray
        self._spec = (step_k, step_budget_bytes)
        self.packed_only = packed_only
        self.last_refresh: dict = {}
        self._build(tables)

    # -- full (re)build ------------------------------------------------------

    def _build(self, tables: DenseTables) -> None:
        self.tables = tables
        S = tables.n_states
        self.V = tables.vocab_size
        self.cap = ms.round_cap(S)
        # Largest per-position match count — scanners bound their per-stream
        # int32 accumulators with it (overflow guard before dispatch).
        self.max_nb = int(tables.nb_outputs.max()) if S else 0
        # Adopt the emitter's capacity buffer when offered (native backend;
        # same round_cap geometry): skips a second whole-table first-touch
        # + copy — ~4 s at 2.5M states on a small host. While adopted,
        # tables.delta aliases delta_host[:S]; any in-place mirror update
        # therefore severs the aliasing first (copy-on-write in refresh).
        buf = tables.claim_cap_delta()
        if buf is not None and buf.shape == (self.cap, self.V):
            self.delta_host = buf
            self._delta_adopted = True
        else:
            self.delta_host = np.zeros((self.cap, self.V), np.int32)
            self.delta_host[:S] = tables.delta
            self._delta_adopted = False
        self.nb_host = np.zeros(self.cap, np.int32)
        self.nb_host[:S] = tables.nb_outputs
        self.dflat = self._place(self.delta_host.reshape(-1))
        self.nb_out = self._place(self.nb_host)

        step_k, budget = self._spec
        auto_k = step_k == "auto"
        if auto_k:
            self.step_k = ms.choose_k(S, self.V, budget)
        else:
            self.step_k = max(1, int(step_k))
        self.stepped = None
        self.st_dev: Tuple = ()
        self._pk_host = self._dk_host = self._ck_host = None
        if self.step_k == 1:
            # k=1 PACKED table: same size as delta but ONE gather per
            # symbol instead of delta + nb_out — the big-automaton count
            # path where no k>=2 table fits the budget. The unpacked k=1
            # form would just duplicate the dense tables, so only the
            # packed form is kept (dense tables stay for states/hits).
            # An EXPLICIT step_k=1 still means "dense tables only" (the
            # documented way to force the non-stepped core in tests).
            if not auto_k:
                return
            # Honor step_budget_bytes like every other k (ADVICE r3): the
            # k=1 packed table is an EXTRA cap*V*4 bytes on top of the
            # dense tables — potentially GBs on the automata this path
            # targets. Callers that want it on big automata opt in with a
            # larger budget (benchmarks/bench_configs.py config 4 does).
            if self.cap * self.V * 4 > budget:
                return
            st = ms.build_stepped(tables, 1, cap_rows=self.cap)
            if st.packed is None:
                return
            self.stepped = st
            self._adopt_packed(st, S)
            return
        if self.step_k > 1:
            st = ms.build_stepped(tables, self.step_k, cap_rows=self.cap)
            # the unpacked fallback needs two tables (8 bytes/entry);
            # degrade k until the actual footprint fits the budget
            while (st is not None and st.packed is None and self.step_k > 1
                   and S * (self.V ** st.k) * 8 > budget):
                self.step_k -= 1
                st = (ms.build_stepped(tables, self.step_k,
                                       cap_rows=self.cap)
                      if self.step_k > 1 else None)
            if st is None or self.step_k <= 1:
                self.step_k = max(1, self.step_k)
                if self.step_k == 1 and self.cap * self.V * 4 <= budget:
                    st = ms.build_stepped(tables, 1, cap_rows=self.cap)
                    if st.packed is not None:
                        self.stepped = st
                        self._adopt_packed(st, S)
                return
            if st.packed is None and self.packed_only:
                return
            self.stepped = st
            if st.packed is not None:
                self._adopt_packed(st, S)
            else:
                self._dk_host = np.zeros((self.cap, st.Vk), np.int32)
                self._dk_host[:S] = st.delta_k.reshape(S, st.Vk)
                self._ck_host = np.zeros((self.cap, st.Vk), np.int32)
                self._ck_host[:S] = st.cnt_k.reshape(S, st.Vk)
                st.delta_k = self._dk_host[:S].reshape(-1)
                st.cnt_k = self._ck_host[:S].reshape(-1)
                self.st_dev = (self._place(self._dk_host.reshape(-1)),
                               self._place(self._ck_host.reshape(-1)))

    def _adopt_packed(self, st, S: int) -> None:
        """Adopt a packed stepped table as the capacity-padded host mirror
        (zero-copy when the snapshot built st itself via cap_rows) and
        upload it."""
        if (st.cap_packed is not None
                and st.cap_packed.size == self.cap * st.Vk):
            self._pk_host = st.cap_packed.reshape(self.cap, st.Vk)
        else:
            self._pk_host = np.zeros((self.cap, st.Vk), np.int32)
            self._pk_host[:S] = st.packed.reshape(S, st.Vk)
        st.packed = self._pk_host[:S].reshape(-1)
        self.st_dev = (self._place(self._pk_host.reshape(-1)),)

    # -- incremental refresh ---------------------------------------------

    def refresh(self, new: DenseTables) -> str:
        """Apply ``new`` (a later snapshot of the same machine) in place.

        Returns "noop" (same content), "inplace" (cell/row scatter), or
        "rebuild" (fell back to a full rebuild — vocabulary growth, state
        capacity, packed-width overflow, or delta too large). Callers must
        serialize this against in-flight scans (buffers are donated)."""
        old = self.tables
        t0 = time.perf_counter()
        self.last_refresh = {}
        if new.vocab_size != self.V or new.n_states > self.cap:
            self._build(new)
            return "rebuild"

        S_old, S_new = old.n_states, new.n_states
        changed = np.zeros(S_new, dtype=bool)
        changed[:S_old] = (
            np.any(old.delta != new.delta[:S_old], axis=1)
            | (old.nb_outputs != new.nb_outputs[:S_old]))
        changed[S_old:] = True
        rows1 = np.flatnonzero(changed).astype(np.int32)
        if not len(rows1):
            self.tables = new
            return "noop"

        n_cells = 0
        stepped_update = None
        if self.stepped is not None:
            st = self.stepped
            cells, land, cnt = ms.stepped_delta_cells(old, new, st.k)
            n_cells = len(cells)
            # Past ~1/4 of the table the plain rebuild+upload wins over
            # recompute+scatter (measured in bench_refresh.py); below 64k
            # cells either path is trivial, so stay in place.
            if n_cells > max(S_new * st.Vk // 4, 1 << 16):
                self._build(new)
                return "rebuild"
            if st.packed is not None:
                max_cnt = int(cnt.max()) if cnt.size else 0
                state_bits = max(1, int(S_new - 1).bit_length())
                if (max_cnt.bit_length() > st.count_bits
                        or state_bits + st.count_bits > 31):
                    self._build(new)
                    return "rebuild"
                vals = ((land.astype(np.int64) << st.count_bits)
                        | cnt).astype(np.int32)
                stepped_update = ("packed", cells, vals)
            else:
                stepped_update = ("unpacked", cells, land,
                                  cnt.astype(np.int32))

        # 1-char tables (scan_states / find_matches / fallback count).
        dvals = new.delta[rows1]
        nvals = new.nb_outputs[rows1]
        # Host mirror: prefer adopting ``new``'s own capacity buffer (its
        # rows already hold the post-refresh values, and the superseded
        # snapshot's buffer is released unmutated); otherwise scatter in
        # place, severing any aliasing with the superseded snapshot first.
        nbuf = new.claim_cap_delta()
        if nbuf is not None and nbuf.shape == (self.cap, self.V):
            self.delta_host = nbuf
            self._delta_adopted = True
        else:
            if self._delta_adopted:
                self.delta_host = self.delta_host.copy()
                self._delta_adopted = False
            self.delta_host[rows1] = dvals
        self.nb_host[rows1] = nvals
        self.dflat = self._scatter(self.dflat, rows1, dvals, self.V)
        self.nb_out = self._scatter(self.nb_out, rows1, nvals, 1)

        if stepped_update is not None:
            st = self.stepped
            if stepped_update[0] == "packed":
                _, cells, vals = stepped_update
                self._pk_host.reshape(-1)[cells] = vals
                st.packed = self._pk_host[:S_new].reshape(-1)
                self.st_dev = (self._scatter(self.st_dev[0], cells, vals, 1),)
            else:
                _, cells, land, c32 = stepped_update
                self._dk_host.reshape(-1)[cells] = land
                self._ck_host.reshape(-1)[cells] = c32
                st.delta_k = self._dk_host[:S_new].reshape(-1)
                st.cnt_k = self._ck_host[:S_new].reshape(-1)
                self.st_dev = (self._scatter(self.st_dev[0], cells, land, 1),
                               self._scatter(self.st_dev[1], cells, c32, 1))

        self.tables = new
        self.max_nb = int(new.nb_outputs.max()) if S_new else 0
        self.last_refresh = {"rows": int(len(rows1)), "cells": int(n_cells),
                             "seconds": time.perf_counter() - t0}
        return "inplace"

    def _scatter(self, table, rows: np.ndarray, vals: np.ndarray,
                 width: int):
        """Scatter in fixed-size chunks so each width compiles exactly ONE
        scatter executable per process — a refresh must never wait on XLA
        (a fresh compile costs seconds, dwarfing the scatter).
        Chunks are padded by repeating the last row; duplicate indices with
        identical values are a benign no-op."""
        chunk = max(1024, (1 << 18) // width)
        fn = _make_row_scatter(width)
        for lo in range(0, len(rows), chunk):
            r = rows[lo:lo + chunk]
            v = vals[lo:lo + chunk]
            if len(r) < chunk:
                pad = chunk - len(r)
                r = np.concatenate([r, np.full(pad, r[-1], r.dtype)])
                v = np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
            table = fn(table, self._place(r), self._place(v))
        return table
