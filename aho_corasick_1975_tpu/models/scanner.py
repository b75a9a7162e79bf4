"""DenseScanner: the device-resident scanning model.

Owns an immutable dense-table snapshot (version-pinned — keywords inserted
into the machine after construction are visible only to a *new* scanner; this
is the device consistency model for the reference's insert-during-scan feature,
README.md:352-356) plus the jitted scan kernels over it.

Scan strategy: B parallel streams with halo overlap (ops/blocking.py), each
step a vectorized gather through the fail-collapsed table (ops/scan_xla.py).
H = max_keyword_len - 1 symbols of warm-up per block make block-local states
exact (proof in ops/blocking.py).
"""

from __future__ import annotations

import threading
import time
from typing import Any, List, Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from ..core.builder import DenseTables
from ..ops import blocking
from ..ops.decode import MatchEvent, decode_matches_arrays  # noqa: F401
from ..ops.scan_xla import (make_blocked_count, make_blocked_count_stream,
                            make_blocked_scan, make_blocked_scan_stream,
                            make_sequential_scan)
from .snapshot import DeviceSnapshot


def _guard_pos32(n_symbols: int) -> None:
    """Retrieval kernels compute hit POSITIONS in device int32 (count
    paths don't — their totals reduce in int64 on the host). Past ~2^31
    symbols an overflowed position would go negative and be silently
    dropped by the keep-filter; refuse instead (margin covers block/
    stream padding)."""
    if n_symbols >= (2 ** 31) - (1 << 20):
        raise ValueError(
            f"retrieval positions are int32 on device and this stream has "
            f"{n_symbols} symbols; chunk it with scanner.session()")


def _is_device_array(x) -> bool:
    """jax.Array input = pre-encoded DEVICE-RESIDENT letter ids (serving a
    corpus already in HBM): no host staging, no re-upload. The caller
    guarantees values lie in [0, V) — validating would force a transfer."""
    import jax
    return isinstance(x, jax.Array) and not isinstance(x, np.ndarray)


def encode_signs(machine, signs, V: int) -> np.ndarray:
    """Shared encode for scanners: map signs to dense letter ids.

    An int32 ndarray is accepted as PRE-ENCODED letter ids (the zero-copy
    fast path used by benchmarks and internal re-entry) — validated to be
    within [0, V) so a raw integer-sign array passed by mistake fails
    loudly instead of scanning garbage.

    Letters registered AFTER this scanner's snapshot carry ids >= V; they
    are masked to OOV here, because for the pinned snapshot they are
    exactly an unknown letter (visible from the NEXT snapshot on — the
    documented insert-during-scan consistency model, ref README.md:352)."""
    if isinstance(signs, np.ndarray) and signs.dtype == np.int32:
        if signs.size and (int(signs.max()) >= V or int(signs.min()) < 0):
            raise ValueError(
                "int32 arrays are treated as pre-encoded letter ids, but "
                f"values fall outside [0, {V}); for integer-sign alphabets "
                "encode via machine.vocab.lookup_many(signs) first")
        return signs
    out = np.asarray(machine.vocab.lookup_many(signs), dtype=np.int32)
    if machine.vocab.size > V and out.size:
        out = np.where(out < V, out, 0)
    return out


def raw_lut_entry(machine, V: int, tables, kind: str, max_cp: int,
                  cache: dict, place):
    """Device LUT for the raw (device-side encode) path: (lut_dev,
    n_entries, needs_max_check, lut_host), or None when the raw path
    cannot be exact. Cached per (vocab version, snapshot V) in ``cache``;
    ``place`` uploads the host LUT (jnp.asarray single-chip, a replicated
    device_put on a mesh); ``lut_host`` is the identical host-side int32
    array — chunk-pipelined scans encode their halo heads through it
    (slicing the ORIGINAL signs by raw offset is wrong for multibyte
    encodings, ADVICE r3). Two contracts enforced here: ids >= V mask to
    OOV (snapshot pinning — letters registered after the snapshot are
    unknown letters for it), and raw 0 must behave exactly like OOV (the
    raw staging pads halo/tail with raw 0): either lut[0] IS OOV, or its
    letter appears in no keyword — every delta column entry roots and the
    root never emits (the reference's modification [3], README.md:347)."""
    vocab = machine.vocab
    key = (kind, getattr(vocab, "_version", 0), V)
    hit = cache.get(key)
    if hit is not None:
        return None if hit == "no" else hit
    fn = getattr(vocab,
                 "byte_lut" if kind == "byte" else "codepoint_lut", None)
    res = None
    if fn is not None:
        res = fn() if kind == "byte" else fn(max_cp)
    if res is None:
        cache.clear()
        cache[key] = "no"
        return None
    if kind == "byte":
        lut, needs_check = np.asarray(res, np.int32).copy(), False
    else:
        lut, needs_check = res
    lut = np.where(lut < V, lut, 0).astype(np.int32)
    lid = int(lut[0])
    if lid != 0 and not bool((tables.delta[:, lid] == 0).all()):
        cache.clear()
        cache[key] = "no"
        return None
    entry = (place(lut), int(lut.shape[0]), needs_check, lut)
    cache.clear()
    cache[key] = entry
    return entry


def raw_stream_for(machine, signs, get_lut):
    """(raw symbol ndarray, lut entry) for device-side encode, or None
    (host-encode path). bytes/uint8 arrays -> raw uint8 through the
    256-entry byte LUT; str -> int32 codepoints through the codepoint
    LUT (utils/vocab.codepoint_lut exactness rules)."""
    if isinstance(signs, (bytes, bytearray)) or (
            isinstance(signs, np.ndarray) and signs.dtype == np.uint8):
        ent = get_lut("byte")
        if ent is None:
            return None
        raw = (np.frombuffer(bytes(signs), np.uint8)
               if not isinstance(signs, np.ndarray) else signs)
        return raw, ent
    if isinstance(signs, str):
        enc = getattr(machine.vocab, "str_encoding", None)
        if enc:  # fixed byte alphabet (ByteMachine): str == its bytes
            ent = get_lut("byte")
            if ent is None:
                return None
            return np.frombuffer(signs.encode(enc), np.uint8), ent
        ent = get_lut("cp")
        if ent is None:
            return None
        cps = np.frombuffer(signs.encode("utf-32-le"),
                            dtype=np.uint32).view(np.int32)
        _, n_lut, needs_check = ent[:3]
        if needs_check and cps.size and int(cps.max()) >= n_lut - 1:
            return None  # beyond the eager LUT: host path stays exact
        return cps, ent
    return None


class DenseScanner:
    def __init__(self, machine, n_streams: "int | str" = "auto",
                 halo: Optional[int] = None,
                 tables: Optional[DenseTables] = None,
                 step_k: "int | str" = "auto",
                 step_budget_bytes: int = 128 * 1024 * 1024,
                 engine: str = "auto",
                 prefilter: str = "off",
                 device_encode: bool = True,
                 device_encode_max_cp: int = 1024,
                 calibrate: bool = False):
        """``engine``: "gather" (packed-table gather scan, the default
        workhorse), "mxu" (one-hot digit-matmul — small automata only,
        raises if the dictionary does not fit), "hybrid" (one scan: most
        stream columns via the packed k-gram gather, the rest via digit
        matmuls — ops/scan_hybrid.py; raises if the automaton exceeds its
        envelope), or "auto" (ops/autotune.auto_engine: the gather, except
        inside an envelope where this backend measured another engine
        faster end to end).

        ``prefilter``: "off" (default), "auto", or "on" — the hybrid
        filter-then-verify count path for low-match-density corpora
        (ops/sparse.py): a host bandwidth pass marks the symbol blocks
        that contain any keyword letter, and the device scans ONLY those
        (exact, via the OOV-resets-to-root contract). "auto" engages when
        at most half the blocks are live; "on" always takes the sparse
        kernel (useful for benchmarking; it only adds overhead on dense
        corpora).

        ``device_encode``: fold the vocab encode into the scan jit for
        bytes / str inputs — raw symbols upload (1 byte/symbol for byte
        corpora) and a replicated LUT gather on device replaces the host
        lookup_many pass. Exact, with automatic fallback to the host path
        whenever the LUT cannot be exact (see utils/vocab.codepoint_lut).
        ``device_encode_max_cp``: eager codepoint-LUT bound for non-default
        key functions (inputs with codepoints beyond it take the host
        path).

        ``calibrate``: with engine="auto", pick the count engine by a
        cached one-shot on-device probe of the production count path
        (ops/autotune.py) instead of the fixed rule. The measured choice
        is cached per (backend, device kind, automaton geometry), so only
        the first scanner of a geometry pays the probe."""
        if engine not in ("auto", "gather", "mxu", "hybrid"):
            raise ValueError(f"unknown engine {engine!r}")
        if prefilter not in ("off", "auto", "on"):
            raise ValueError(f"unknown prefilter {prefilter!r}")
        # Persistent XLA compile cache (round 5): the next process of a
        # serving fleet reads this geometry's executables from disk
        # instead of paying the 20-40 s first compile again. Opt-out via
        # ACX_COMPILE_CACHE=off (utils/compile_cache.py).
        from ..utils.compile_cache import enable_compile_cache
        enable_compile_cache()
        self._engine = engine
        self._prefilter = prefilter
        self.machine = machine
        self._halo_auto = halo is None
        # "auto": scale the stream count with the input at layout time
        # (clamped 512..16384 — sweeps show throughput is flat in B beyond
        # a few thousand, and tiny inputs waste padding on huge B).
        self._auto_streams = n_streams == "auto"
        self.n_streams = 512 if self._auto_streams else int(n_streams)
        # Device tables live in a capacity-padded snapshot so that refresh()
        # can grow the dictionary in place with stable shapes.
        self._snap = DeviceSnapshot(
            tables if tables is not None else machine.compile(),
            step_k=step_k, step_budget_bytes=step_budget_bytes)
        self.halo = int(halo) if halo is not None else max(
            self.tables.max_depth - 1, 0)
        self.stats: dict = {}
        # Host staging buffers for the stream kernels, reused per size.
        # Reuse is safe where an upload copies the host buffer (the GPU
        # backend): every public call materializes its result
        # (np.asarray/int) before returning, which fences the previous
        # transfer. The CPU backend zero-copy ALIASES numpy buffers, so
        # there each upload takes a fresh copy.
        self._ext_bufs: dict = {}
        import jax
        self._reuse_buf = jax.default_backend() == "gpu"
        # Per-scanner dispatch lock: every public device call stages into
        # reused host buffers, dispatches, and materializes the result; two
        # threads interleaving stage+dispatch on one scanner would corrupt
        # the shared staging buffers (ADVICE r2). The lock spans
        # stage→dispatch→materialize, making concurrent calls on ONE
        # scanner safe (they serialize); use one scanner per thread for
        # parallel scanning. Reentrant: count() takes it and may re-enter
        # through _sparse_count.
        self._dispatch = threading.RLock()
        self._device_encode = bool(device_encode)
        self._device_encode_max_cp = int(device_encode_max_cp)
        self._lut_cache: dict = {}
        self._bind_kernels()
        if calibrate and engine == "auto":
            self._calibrate_engine()

    def _calibrate_engine(self, force: bool = False) -> None:
        """Replace the heuristic auto-selection with a measured one
        (ops/autotune.py): probe every available engine's production
        count() once, keep the fastest, cache the choice. Runs under the
        dispatch lock — engine/kernel rebinds must never interleave with a
        live scan on another thread (VERDICT r3 #7)."""
        from ..ops import autotune
        with self._dispatch:
            candidates = autotune.engine_candidates(self.tables,
                                                    self._snap.stepped)
            choice = "gather"
            if len(candidates) > 1:
                key = autotune.geometry_key(self.tables.n_states, self.V,
                                            self.step_k)
                choice = None if force else autotune.cached_choice(key)
                if choice not in candidates:
                    choice = autotune.probe(self, candidates)
                    autotune.store_choice(key, choice)
            self._engine = choice
            self._bind_kernels()

    def recalibrate(self) -> str:
        """Re-measure the engine choice on this device NOW (ignoring the
        cached choice) and rebind — safe against concurrent scans on other
        threads (serializes on the dispatch lock). Returns the winning
        engine name."""
        self._calibrate_engine(force=True)
        return self._engine

    # Snapshot delegation (the snapshot owns tables + device arrays; the
    # scanner owns kernels, layout, and sessions).
    @property
    def tables(self) -> DenseTables:
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
    def _st_dev(self):
        return self._snap.st_dev

    @property
    def _dflat(self):
        return self._snap.dflat

    @property
    def _nb_out(self):
        return self._snap.nb_out

    @property
    def _cap(self) -> int:
        return self._snap.cap

    def _bind_kernels(self) -> None:
        """(Re)bind jitted kernels to the snapshot's current geometry.

        The kernel factories are lru-cached on their constants, so
        rebinding after a refresh/rebuild compiles something new only when
        V / halo / k / count_bits actually changed."""
        from ..ops import multistep as ms
        self._blocked_scan = make_blocked_scan(self.V)
        self._blocked_count = make_blocked_count(self.V, self.halo)
        self._seq_scan = make_sequential_scan(self.V)
        st = self._snap.stepped
        if st is not None:
            self._halo_steps = -(-self.halo // st.k)
            self._halo_sym = self._halo_steps * st.k
            if st.packed is not None:
                self._stepped_count = ms.make_stepped_count(
                    st.V, st.k, st.Vk, st.count_bits, self._halo_steps)
            else:
                self._stepped_count = ms.make_stepped_count_unpacked(
                    st.V, st.k, st.Vk, self._halo_steps)
        else:
            self._halo_steps = 0
            self._halo_sym = 0
        # Count engine (ops/autotune.resolve_engine): the MXU-style
        # digit-matmul engine or the hybrid gather+matmul engine take
        # priority over the stepped gather path when bound. Planes are
        # rebuilt on every (re)bind, so refresh() keeps them in sync.
        from ..ops import autotune
        self._mxu, self._hybrid = autotune.resolve_engine(
            self._engine, self.tables, self._stepped, jnp.asarray)

    @property
    def version(self) -> int:
        return self.tables.version

    # -- incremental snapshot refresh ---------------------------------------

    def refresh(self) -> bool:
        """Bring the pinned snapshot up to the machine's current dictionary
        by updating the device tables in place.

        The reference allows keyword registration *during* scanning
        (README.md:352-356, exercised at generic_test.c:214-232); the device
        consistency model pins each scanner to a table snapshot, and
        refresh() is the cheap bridge between snapshots. Meyer-mode
        insertions typically touch a handful of automaton rows, so instead
        of rebuilding and re-uploading the O(S*V^k) stepped table it

        1. re-emits dense tables (host, O(S*V)),
        2. diffs them against the pinned snapshot,
        3. recomputes exactly the stepped-table CELLS routed through a
           changed edge (ops/multistep.stepped_delta_cells),
        4. scatters them into the capacity-padded device tables
           (donated buffers: in-place, no shape change, no XLA recompile).

        Returns True for the in-place path, False when it fell back to a
        full reconstruction (vocabulary growth, packed-count-width
        overflow, or state capacity exceeded). Either way the scanner
        afterwards matches a freshly constructed one exactly
        (tests/test_refresh.py). Open StreamSessions keep feeding: a
        session sees the refreshed dictionary from its next chunk on
        (snapshot analogue of the reference's "new keywords affect
        subsequent symbols only").

        Concurrency: all device calls on one scanner — scans AND this
        refresh — serialize on the scanner's internal dispatch lock (the
        staging buffers are shared and the refresh donates device buffers),
        so concurrent use of one scanner is safe but not parallel; use one
        scanner per thread for parallel scanning. The reference takes the
        machine mutex for insertion and scans lock-free (c:295,433); here
        insertion is likewise safe anytime.
        """
        t0 = time.perf_counter()
        new = self.machine.compile()
        if new.version == self.tables.version:
            return True
        with self._dispatch:
            status = self._snap.refresh(new)
            self._refresh_halo()
            self._bind_kernels()
        self._record("refresh", self._snap.last_refresh.get("rows", 0),
                     time.perf_counter() - t0)
        self.stats["refresh_rows"] = self._snap.last_refresh.get("rows", 0)
        self.stats["refresh_cells"] = self._snap.last_refresh.get("cells", 0)
        return status != "rebuild"

    def _refresh_halo(self) -> None:
        """Grow the halo when a new keyword exceeds it (auto-halo mode).

        Rounded up to a multiple of 8 on growth so steady keyword-length
        creep doesn't force a fresh count-kernel compile every refresh."""
        need = max(self.tables.max_depth - 1, 0)
        if self._halo_auto and need > self.halo:
            self.halo = -(-need // 8) * 8

    # -- encoding ----------------------------------------------------------

    def encode(self, signs: Sequence[Any]) -> np.ndarray:
        """Map a stream of signs to dense letter ids (OOV -> 0). int32
        arrays pass through as pre-encoded ids (bounds-checked)."""
        return encode_signs(self.machine, signs, self.V)

    # -- device-side encode (raw path) --------------------------------------

    def _get_lut(self, kind: str):
        return raw_lut_entry(self.machine, self.V, self.tables, kind,
                             self._device_encode_max_cp, self._lut_cache,
                             jnp.asarray)

    def _raw_stream(self, signs):
        """(raw symbol ndarray, lut entry) for device-side encode, or None
        (host-encode path) — see raw_stream_for."""
        if not self._device_encode:
            return None
        return raw_stream_for(self.machine, signs, self._get_lut)

    def _stream_ext_raw(self, raw: np.ndarray, head, halo: int, unit: int):
        """Stage a RAW symbol stream + ID-space head for the *_raw kernels:
        ext_raw [halo + B*L] in the raw dtype (halo region and tail padded
        with raw 0 — lut[0] == OOV by the _get_lut contract; column 0's
        halo rows are overwritten on device by head_ids). The host work is
        one memcpy of the raw input — for byte corpora both the staging
        pass and the host->device transfer shrink 4x vs the id path."""
        T = len(raw)
        B = self._streams_for(T)
        L = max(unit, -(-(-(-T // B)) // unit) * unit)
        n = halo + B * L
        key = (raw.dtype.char, n)
        buf = self._ext_bufs.get(key) if self._reuse_buf else None
        if buf is None:
            buf = np.zeros(n, raw.dtype)
            if self._reuse_buf:
                self._ext_bufs[key] = buf
        buf[:halo] = 0
        buf[halo:halo + T] = raw
        buf[halo + T:] = 0
        head_ids = np.zeros(halo, np.int32)
        if head is not None and len(head) and halo:
            h = min(len(head), halo)
            head_ids[halo - h:] = head[-h:]
        return jnp.asarray(buf), jnp.asarray(head_ids), B, L, T

    # -- layout ------------------------------------------------------------

    def _streams_for(self, T: int) -> int:
        if not self._auto_streams:
            return self.n_streams
        b = max(512, min(16384, T // 4096))
        return 1 << (b - 1).bit_length()  # pow2 bucket: few compiled shapes

    def _stream_ext(self, ids: np.ndarray, head, halo: int, unit: int):
        """Stage the stream for a device-side window layout: one contiguous
        [halo + B*L] int32 buffer (left halo, ids, OOV tail pad). The only
        host work per scan is this memcpy — the [halo+L, B] windowing
        (a cache-hostile strided transpose when done on host) runs on
        device via ops.scan_xla.window_layout."""
        T = len(ids)
        B = self._streams_for(T)
        L = max(unit, -(-(-(-T // B)) // unit) * unit)
        n = halo + B * L
        buf = self._ext_bufs.get(n) if self._reuse_buf else None
        if buf is None:
            buf = np.zeros(n, np.int32)
            if self._reuse_buf:
                self._ext_bufs[n] = buf
        buf[:halo] = 0
        if head is not None and len(head) and halo:
            h = min(len(head), halo)
            buf[halo - h:halo] = head[-h:]
        buf[halo:halo + T] = ids
        buf[halo + T:] = 0
        return jnp.asarray(buf), B, L, T

    def _layout(self, ids: np.ndarray, head=None) -> Tuple[np.ndarray, int, int]:
        T = len(ids)
        B = self._streams_for(T)
        # Round the per-stream length to a small bucket: bounds padding waste
        # to <128*B symbols while keeping the number of distinct compiled
        # shapes low for steadily-sized inputs.
        L = max(32, -(-(-(-T // B)) // 128) * 128)
        blocks_tm, nb = blocking.block_time_major(ids, L, self.halo, head=head)
        return blocks_tm, nb, T

    # -- scanning ----------------------------------------------------------

    def scan_states(self, signs, head=None) -> np.ndarray:
        """states[t] after consuming symbol t, for the whole stream
        (blocked-parallel on device, exact per-position states)."""
        if len(signs) == 0:
            return np.zeros(0, dtype=np.int32)
        t0 = time.perf_counter()
        raw = self._raw_stream(signs)
        with self._dispatch:
            if raw is not None:
                from ..ops.scan_xla import make_blocked_scan_raw
                ext, head_ids, B, L, T = self._stream_ext_raw(
                    raw[0], head, self.halo, 128)
                fn = make_blocked_scan_raw(self.V, self.halo, B, L)
                out = np.asarray(fn(self._dflat, raw[1][0], ext,
                                    head_ids))[:T]
            elif _is_device_array(signs):
                import jax.numpy as _jnp
                if not _jnp.issubdtype(signs.dtype, _jnp.integer):
                    raise ValueError(
                        "device-array input must be integer letter ids "
                        f"(got dtype {signs.dtype})")
                ext, B, L = self._ext_device(signs, head, self.halo, 128)
                T = int(signs.shape[0])
                fn = make_blocked_scan_stream(self.V, self.halo, B, L)
                out = np.asarray(fn(self._dflat, ext))[:T]
            else:
                ids = self.encode(signs)
                ext, B, L, T = self._stream_ext(ids, head, self.halo, 128)
                fn = make_blocked_scan_stream(self.V, self.halo, B, L)
                out = np.asarray(fn(self._dflat, ext))[:T]
        self._record("scan_states", T, time.perf_counter() - t0)
        return out

    def count(self, signs, head=None) -> int:
        """Total number of keyword occurrences in the stream (fused count,
        nothing materialized per position; k-char stepped when enabled).

        bytes / str inputs take the raw device-encode path when exact
        (LUT gather inside the scan jit — see ``device_encode``); other
        inputs (and the sparse prefilter) encode on the host."""
        from ..ops import multistep as ms
        if len(signs) == 0:
            return 0
        t0 = time.perf_counter()
        if self._prefilter == "off":
            raw = self._raw_stream(signs)
            if raw is not None:
                with self._dispatch:
                    n = None
                    if len(raw[0]) >= self._pipeline_min:
                        n = self._count_raw_pipelined(raw[0], raw[1], head)
                    if n is None:
                        n = self._count_raw(raw[0], raw[1], head)
                if n is not None:
                    self._record("count", len(signs),
                                 time.perf_counter() - t0)
                    return n
        if _is_device_array(signs):
            with self._dispatch:
                n = self._count_device(signs, head)
            self._record("count", int(signs.shape[0]),
                         time.perf_counter() - t0)
            return n
        if self._prefilter != "off":
            # Raw-input elision: filter + window-gather BEFORE any encode
            # (two bandwidth passes over the raw input; the rest of the
            # cost is proportional to the live fraction).
            raw = self._raw_stream(signs)
            if raw is not None:
                with self._dispatch:
                    n = self._sparse_count_raw(raw[0], raw[1], head)
                if isinstance(n, int):
                    self._record("count", len(raw[0]),
                                 time.perf_counter() - t0)
                    return n
                if n == "dense":
                    # The raw filter already measured the corpus as
                    # match-dense ("auto" gate): skip the redundant
                    # id-path filter and take the dense raw engines
                    # directly (review r4 — the duplicate full-corpus
                    # passes were the cost being optimized away).
                    with self._dispatch:
                        n = None
                        if len(raw[0]) >= self._pipeline_min:
                            n = self._count_raw_pipelined(raw[0], raw[1],
                                                          head)
                        if n is None:
                            n = self._count_raw(raw[0], raw[1], head)
                    if n is not None:
                        self._record("count", len(signs),
                                     time.perf_counter() - t0)
                        return n
        ids = self.encode(signs)
        if len(ids) == 0:
            return 0
        with self._dispatch:
            if self._prefilter != "off":
                n = self._sparse_count(ids, head)
                if n is not None:
                    self._record("count", len(ids),
                                 time.perf_counter() - t0)
                    return n

            def get_ext(halo, unit):
                return self._stream_ext(ids, head, halo, unit)[:3]

            n = self._count_dispatch(get_ext)
        self._record("count", len(ids), time.perf_counter() - t0)
        return n

    # Chunked-pipeline thresholds: past _pipeline_min symbols, a raw host
    # input is split into _pipeline_chunk-symbol chunks dispatched without
    # intermediate syncs, overlapping each chunk's host->device transfer
    # with the previous chunk's scan. Chunks are INDEPENDENT launches:
    # each one's halo comes from the raw input itself (host data), so no
    # device round-trip serializes them — the blocked-scan exactness
    # argument (ops/blocking.py) applied at chunk granularity.
    # Chunk size trades per-chunk dispatch overhead against overlap
    # depth; not yet measured on the GPU (benchmarks/bench_e2e_variance.py
    # sweeps it).
    _pipeline_min = 16 << 20
    _pipeline_chunk = 8 << 20

    def _count_raw_pipelined(self, raw, ent, head) -> Optional[int]:
        """Pipelined raw-path count for large host inputs. Returns None
        when the active engine has no raw kernel — caller falls through."""
        from ..ops import multistep as ms
        lut_dev, n_lut, _, lut_host = ent
        st = self._stepped
        if self._mxu is not None:
            from ..ops import scan_mxu
            halo, unit = self.halo, 128
            planes, cbits, n_planes, S_pad = self._mxu

            def make(B, L):
                fn = scan_mxu.make_mxu_count_raw(
                    self.V, S_pad, cbits, n_planes, self.halo, B, L)
                return lambda e, h: fn(planes, lut_dev, e, h)
        elif self._hybrid is not None:
            from ..ops import scan_hybrid
            halo, unit = self._halo_sym, 128 * st.k
            planes, cbm, n_planes, S_pad = self._hybrid

            def make(B, L):
                B2 = scan_hybrid.mxu_cols(B, S_pad)
                fn = scan_hybrid.make_hybrid_count_raw(
                    st.V, st.k, st.Vk, st.count_bits, self._halo_steps,
                    S_pad, n_planes, cbm, B - B2, B2, L)
                return lambda e, h: fn(self._st_dev[0], planes, lut_dev,
                                       e, h)
        elif st is not None and st.packed is not None:
            halo, unit = self._halo_sym, 128 * st.k

            def make(B, L):
                fn = ms.make_stepped_count_raw(
                    st.V, st.k, st.Vk, st.count_bits, self._halo_steps,
                    B, L)
                return lambda e, h: fn(self._st_dev[0], lut_dev, e, h)
        elif st is not None:
            return None  # unpacked two-table fallback: host path
        else:
            from ..ops.scan_xla import make_blocked_count_raw
            halo, unit = self.halo, 128

            def make(B, L):
                fn = make_blocked_count_raw(self.V, self.halo, B, L)
                return lambda e, h: fn(self._dflat, self._nb_out, e, h)

        T = len(raw)
        C = self._pipeline_chunk
        n_chunks = -(-T // C)
        if n_chunks < 2:
            return None
        B = self._streams_for(C)
        L = max(unit, -(-(-(-C // B)) // unit) * unit)
        self._guard_acc(L)
        fn = make(B, L)
        n_ext = halo + B * L
        partials = []
        for i in range(n_chunks):
            start, end = i * C, min(T, (i + 1) * C)
            # fresh buffer per chunk: the transfer is still in flight when
            # the next chunk stages (that overlap is the whole point)
            buf = np.zeros(n_ext, raw.dtype)
            buf[halo:halo + (end - start)] = raw[start:end]
            head_ids = np.zeros(halo, np.int32)
            if i == 0:
                if head is not None and len(head) and halo:
                    h = min(len(head), halo)
                    head_ids[halo - h:] = head[-h:]
            elif halo:
                # Encode the halo head from the RAW stream through the same
                # LUT the kernel gathers with (NOT by slicing the original
                # signs: start is a raw byte/codepoint offset, and for a
                # UTF-8 str corpus byte index != char index — ADVICE r3
                # high). np.minimum mirrors XLA's clamping gather: the last
                # LUT entry is the OOV sentinel for out-of-range codepoints.
                head_raw = np.minimum(
                    raw[start - halo:start].astype(np.int64), n_lut - 1)
                head_ids[:] = lut_host[head_raw]
            partials.append(fn(jnp.asarray(buf), jnp.asarray(head_ids)))
        return sum(int(np.asarray(p).sum(dtype=np.int64))
                   for p in partials)

    def _count_dispatch(self, get_ext) -> int:
        """Engine-select and run a count over an ext stream buffer.
        ``get_ext(halo, unit) -> (ext [halo + B*L], B, L)`` — host-staged
        (_stream_ext) or built on device (_count_device)."""
        from ..ops import multistep as ms
        st = self._stepped
        if self._mxu is not None:
            from ..ops import scan_mxu
            planes, cbits, n_planes, S_pad = self._mxu
            ext, B, L = get_ext(self.halo, 128)
            steps = self.halo + L
            self._guard_acc(L)
            fn = scan_mxu.make_mxu_count_stream(
                self.V, S_pad, cbits, n_planes, self.halo, B, L)
            per_stream = fn(planes, ext)
        elif self._hybrid is not None:
            from ..ops import scan_hybrid
            planes, cbm, n_planes, S_pad = self._hybrid
            ext, B, L = get_ext(self._halo_sym, 128 * st.k)
            steps = self._halo_steps + L // st.k
            self._guard_acc(L)
            B2 = scan_hybrid.mxu_cols(B, S_pad)
            fn = scan_hybrid.make_hybrid_count_stream(
                st.V, st.k, st.Vk, st.count_bits, self._halo_steps,
                S_pad, n_planes, cbm, B - B2, B2, L)
            per_stream = fn(self._st_dev[0], planes, ext)
        elif st is not None:
            ext, B, L = get_ext(self._halo_sym, 128 * st.k)
            steps = self._halo_steps + L // st.k
            self._guard_acc(L)
            if st.packed is not None:
                fn = ms.make_stepped_count_stream(
                    st.V, st.k, st.Vk, st.count_bits,
                    self._halo_steps, B, L)
            else:
                fn = ms.make_stepped_count_unpacked_stream(
                    st.V, st.k, st.Vk, self._halo_steps, B, L)
            per_stream = fn(*self._st_dev, ext)
        else:
            ext, B, L = get_ext(self.halo, 128)
            steps = self.halo + L
            self._guard_acc(L)
            fn = make_blocked_count_stream(self.V, self.halo, B, L)
            per_stream = fn(self._dflat, self._nb_out, ext)
        # launch geometry: B parallel streams, one lax.scan of `steps`
        self.stats["last_launch"] = {"streams": B, "scan_steps": steps}
        # int64 grand total on host: per-stream totals are int32-safe
        # but their sum can exceed 2^31 on pod-scale corpora.
        return int(np.asarray(per_stream).sum(dtype=np.int64))

    def _ext_device(self, ids, head, halo: int, unit: int):
        """Device-side ext construction for DEVICE-RESIDENT corpora: the
        [halo + B*L] stream buffer is concatenated in-graph — no host
        staging, no re-upload (serving a corpus already in HBM)."""
        T = int(ids.shape[0])
        B = self._streams_for(T)
        L = max(unit, -(-(-(-T // B)) // unit) * unit)
        head_ids = np.zeros(halo, np.int32)
        if head is not None and len(head) and halo:
            h = min(len(head), halo)
            head_ids[halo - h:] = head[-h:]
        ext = jnp.concatenate([
            jnp.asarray(head_ids),
            ids.astype(jnp.int32) if ids.dtype != jnp.int32 else ids,
            jnp.zeros(B * L - T, jnp.int32)])
        return ext, B, L

    def _count_device(self, ids, head) -> int:
        """Count over a device-resident int32 id array (jax.Array input):
        ext built in-graph; the sparse prefilter runs its block filter ON
        DEVICE (ops/sparse.make_block_filter) — no host filter pass and no
        index upload (VERDICT r2 item 4)."""
        if not jnp.issubdtype(ids.dtype, jnp.integer):
            raise ValueError(
                "device-array input must be integer letter ids "
                f"(got dtype {ids.dtype})")
        if int(ids.shape[0]) == 0:
            return 0
        if self._prefilter != "off":
            n = self._sparse_count_device(ids, head)
            if n is not None:
                return n
        return self._count_dispatch(
            lambda halo, unit: self._ext_device(ids, head, halo, unit))

    def _sparse_count_device(self, ids, head) -> Optional[int]:
        """Filter-then-verify with the block filter on device: one kernel
        computes the live-block order + count, one 4-byte sync fetches the
        live count (to pick the pow2 gather capacity), and the gather/scan
        kernel consumes the DEVICE-RESIDENT order array — eliminating the
        host bandwidth pass, the index upload, and the host-resident-ids
        requirement of the host filter path."""
        from ..ops import sparse
        st = self._stepped
        use_stepped = (self._mxu is None and st is not None
                       and st.packed is not None)
        k = st.k if use_stepped else 1
        halo = self._halo_sym if use_stepped else self.halo
        L_blk = 128 * k
        if halo > L_blk:
            return None
        T = int(ids.shape[0])
        nB_real = -(-T // L_blk)
        nB = 1 << (nB_real - 1).bit_length()
        n_ext = halo + (nB + 1) * L_blk
        head_ids = np.zeros(halo, np.int32)
        if head is not None and len(head) and halo:
            h = min(len(head), halo)
            head_ids[halo - h:] = head[-h:]
        ext = jnp.concatenate([
            jnp.asarray(head_ids),
            ids.astype(jnp.int32) if ids.dtype != jnp.int32 else ids,
            jnp.zeros(n_ext - halo - T, jnp.int32)])
        order, n_live_dev = sparse.make_block_filter(nB, L_blk, halo)(ext)
        n_live = int(n_live_dev)  # the one tiny host sync
        self.stats["sparse_live_frac"] = n_live / max(nB_real, 1)
        if n_live == 0:
            return 0
        if self._prefilter == "auto" and n_live * 2 > nB_real:
            return None
        cap = min(nB, max(8, 1 << (n_live - 1).bit_length()))
        if self._mxu is not None:
            planes, cbits, n_planes, S_pad = self._mxu
            fn = sparse.make_sparse_count_mxu_dev(
                self.V, S_pad, cbits, n_planes, halo, L_blk, nB, cap)
            per = fn(planes, ext, order, n_live_dev)
        elif use_stepped:
            fn = sparse.make_sparse_count_stepped_dev(
                st.V, st.k, st.Vk, st.count_bits, self._halo_steps,
                L_blk, nB, cap)
            per = fn(self._st_dev[0], ext, order, n_live_dev)
        else:
            fn = sparse.make_sparse_count_dev(self.V, halo, L_blk, nB, cap)
            per = fn(self._dflat, self._nb_out, ext, order, n_live_dev)
        return int(np.asarray(per).sum(dtype=np.int64))

    def _count_raw(self, raw: np.ndarray, ent, head) -> Optional[int]:
        """Raw-path count dispatch (device-side encode). Returns None when
        the active engine has no raw kernel (unpacked stepped fallback),
        letting count() fall through to the host-encode path."""
        lut_dev = ent[0]
        st = self._stepped
        if self._mxu is not None:
            from ..ops import scan_mxu
            planes, cbits, n_planes, S_pad = self._mxu
            ext, head_ids, B, L, _ = self._stream_ext_raw(
                raw, head, self.halo, 128)
            self._guard_acc(L)
            fn = scan_mxu.make_mxu_count_raw(
                self.V, S_pad, cbits, n_planes, self.halo, B, L)
            per_stream = fn(planes, lut_dev, ext, head_ids)
        elif self._hybrid is not None:
            from ..ops import scan_hybrid
            planes, cbm, n_planes, S_pad = self._hybrid
            ext, head_ids, B, L, _ = self._stream_ext_raw(
                raw, head, self._halo_sym, 128 * st.k)
            self._guard_acc(L)
            B2 = scan_hybrid.mxu_cols(B, S_pad)
            fn = scan_hybrid.make_hybrid_count_raw(
                st.V, st.k, st.Vk, st.count_bits, self._halo_steps,
                S_pad, n_planes, cbm, B - B2, B2, L)
            per_stream = fn(self._st_dev[0], planes, lut_dev, ext, head_ids)
        elif st is not None and st.packed is not None:
            from ..ops import multistep as ms
            ext, head_ids, B, L, _ = self._stream_ext_raw(
                raw, head, self._halo_sym, 128 * st.k)
            self._guard_acc(L)
            fn = ms.make_stepped_count_raw(
                st.V, st.k, st.Vk, st.count_bits, self._halo_steps, B, L)
            per_stream = fn(self._st_dev[0], lut_dev, ext, head_ids)
        elif st is not None:
            return None  # unpacked two-table fallback: host path
        else:
            from ..ops.scan_xla import make_blocked_count_raw
            ext, head_ids, B, L, _ = self._stream_ext_raw(
                raw, head, self.halo, 128)
            self._guard_acc(L)
            fn = make_blocked_count_raw(self.V, self.halo, B, L)
            per_stream = fn(self._dflat, self._nb_out, lut_dev, ext,
                            head_ids)
        return int(np.asarray(per_stream).sum(dtype=np.int64))

    def _guard_acc(self, stream_symbols: int) -> None:
        """Pre-dispatch overflow guard: per-stream totals accumulate in
        int32 on device (the first level of the two-level reduction). A
        stream of L symbols can contribute at most L * max(nb_outputs)
        matches — the same bound for every engine (the k-gram count of a
        gram is the sum of its k per-symbol counts). Raise rather than
        wrap (ADVICE r2)."""
        if stream_symbols * max(self._snap.max_nb, 1) >= 2 ** 31:
            raise ValueError(
                f"a stream of {stream_symbols} symbols with up to "
                f"{self._snap.max_nb} matches/position could overflow the "
                "int32 per-stream accumulator; chunk the input with "
                "scanner.session() or raise n_streams")

    def _sparse_count(self, ids: np.ndarray, head) -> Optional[int]:
        """Filter-then-verify count (ops/sparse.py): host bandwidth pass
        marks live L_blk-symbol blocks; the device gathers and scans only
        their halo windows. Returns None when not profitable ("auto" with
        more than half the blocks live) or not applicable (halo wider than
        a block), letting count() fall through to the dense kernels."""
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
        live = sparse.live_blocks(ids, L_blk)
        n_live = int(live.sum())
        self.stats["sparse_live_frac"] = n_live / nB_real
        if n_live == 0:
            return 0  # all-OOV: nothing can match, no device launch
        if self._prefilter == "auto" and n_live * 2 > nB_real:
            return None
        # Host-side dead-block ELISION (VERDICT r3 stretch #8): when the
        # compacted live windows are under half the stream, upload ONLY
        # them — wire bytes drop with density, so end-to-end throughput
        # on sparse corpora can exceed the raw device_put floor (the full
        # -stream upload is otherwise the e2e bound on this rig).
        if n_live * (halo + L_blk) * 2 < max(T, 1):
            n = self._sparse_count_elided(ids, live, n_live, head, halo,
                                          L_blk, nB_real, use_stepped)
            if n is not None:
                return n
        # pow2 buckets so steady sizes reuse one compiled kernel
        nB = 1 << (nB_real - 1).bit_length()
        cap = max(8, 1 << (n_live - 1).bit_length())
        n_ext = halo + (nB + 1) * L_blk
        key = ("sparse", n_ext)
        buf = self._ext_bufs.get(key) if self._reuse_buf else None
        if buf is None:
            buf = np.zeros(n_ext, np.int32)
            if self._reuse_buf:
                self._ext_bufs[key] = buf
        buf[:halo] = 0
        if head is not None and len(head) and halo:
            h = min(len(head), halo)
            buf[halo - h:halo] = head[-h:]
        buf[halo:halo + T] = ids
        buf[halo + T:] = 0
        idx = np.full(cap, nB, np.int32)   # pad -> the spare all-OOV block
        idx[:n_live] = np.flatnonzero(live)
        if self._mxu is not None:
            planes, cbits, n_planes, S_pad = self._mxu
            fn = sparse.make_sparse_count_mxu(
                self.V, S_pad, cbits, n_planes, halo, L_blk, nB, cap)
            per = fn(planes, jnp.asarray(buf), jnp.asarray(idx))
        elif use_stepped:
            fn = sparse.make_sparse_count_stepped(
                st.V, st.k, st.Vk, st.count_bits, self._halo_steps,
                L_blk, nB, cap)
            per = fn(self._st_dev[0], jnp.asarray(buf), jnp.asarray(idx))
        else:
            fn = sparse.make_sparse_count(self.V, halo, L_blk, nB, cap)
            per = fn(self._dflat, self._nb_out, jnp.asarray(buf),
                     jnp.asarray(idx))
        return int(np.asarray(per).sum(dtype=np.int64))

    def _sparse_count_elided(self, ids, live, n_live: int, head,
                             halo: int, L_blk: int, nB_real: int,
                             use_stepped: bool) -> Optional[int]:
        """Sparse count with host-side dead-block elision over pre-encoded
        ids — see _elided_count_core."""
        return self._elided_count_core(ids, None, len(ids), live, n_live,
                                       head, halo, L_blk, nB_real,
                                       use_stepped)

    def _sparse_count_raw(self, raw: np.ndarray, ent, head):
        """RAW-input sparse count with dead-block elision: the live-block
        filter runs over the RAW symbols through the host LUT (one pass
        over 1 byte/symbol for byte corpora — before any encode), and
        only the live windows are gathered, encoded, and uploaded. The
        whole-corpus cost collapses to two bandwidth passes over the raw
        input; everything downstream is proportional to the live
        fraction. Returns an int count, the string "dense" (the "auto"
        density gate measured the corpus as match-dense — caller should
        take the dense raw engines WITHOUT re-filtering), or None (not
        applicable/profitable — the host-encode sparse path decides)."""
        from ..ops.sparse import raw_elision_plan
        lut_host = ent[3]
        n_lut = ent[1]
        st = self._stepped
        use_stepped = (self._mxu is None and st is not None
                       and st.packed is not None)
        k = st.k if use_stepped else 1
        halo = self._halo_sym if use_stepped else self.halo
        verdict, live, n_live, nB_real = raw_elision_plan(
            raw, lut_host, n_lut, self._prefilter, halo, 128 * k)
        if live is not None:
            self.stats["sparse_live_frac"] = n_live / max(nB_real, 1)
        if verdict == "zero":
            return 0
        if verdict in ("dense", "na"):
            return "dense" if verdict == "dense" else None
        return self._elided_count_core(raw, (lut_host, n_lut), len(raw),
                                       live, n_live, head, halo, 128 * k,
                                       nB_real, use_stepped)

    def _elided_count_core(self, arr, lut, T: int, live, n_live: int,
                           head, halo: int, L_blk: int, nB_real: int,
                           use_stepped: bool) -> int:
        """Host dead-block elision (ops/sparse.elide_windows): upload ONLY
        the live blocks' halo windows into the standard count cores —
        wire bytes = live fraction x corpus."""
        from ..ops.sparse import elide_windows
        st = self._stepped
        tm, _ = elide_windows(arr, lut, T, live, n_live, head, halo,
                              L_blk, nB_real)
        self._guard_acc(halo + L_blk)
        from ..ops import multistep as ms
        if self._mxu is not None:
            from ..ops import scan_mxu
            planes, cbits, n_planes, S_pad = self._mxu
            fn = scan_mxu.make_mxu_count_halo(self.V, S_pad, cbits,
                                              n_planes, halo)
            per = fn(planes, jnp.asarray(tm))
        elif use_stepped:
            fn = ms.make_stepped_count(st.V, st.k, st.Vk, st.count_bits,
                                       self._halo_steps)
            per = fn(self._st_dev[0], jnp.asarray(tm))
        else:
            fn = make_blocked_count(self.V, halo)
            per = fn(self._dflat, self._nb_out, jnp.asarray(tm))
        self.stats["sparse_elided_upload_bytes"] = int(tm.nbytes)
        return int(np.asarray(per).sum(dtype=np.int64))

    def count_many(self, docs: Sequence[Sequence[Any]]) -> np.ndarray:
        """Per-document match counts for a batch of independent documents,
        in ONE device launch (serving batch scoring).

        The reference scores one stream per machine cursor (c:433-448); a
        batch of documents there is a Python-side loop. Here each document
        occupies its own stream column of a single [L, B] launch: documents
        start at the root, so no halo warm-up is needed, and streams are
        padded with the OOV id 0 — vocab id 0 appears in no keyword, so it
        transitions every state to the root and never emits (the reference's
        modification [3], README.md:347), contributing exactly zero.

        Documents are grouped into length buckets (pow2 multiples of
        128*k) and launched per bucket, B rounded to multiples of 8 — so
        steadily-sized batches reuse one compiled kernel per bucket and a
        single long outlier costs only its own bucket's launch. Returns an
        int64 array of len(docs) counts.

        Round 5 (VERDICT r4 #6): when every document rides the raw path
        (bytes/str through one LUT), the batch stages RAW — 1 byte per
        symbol on byte corpora (4x less wire) with the vocab encode
        inside the kernel per column, the stream kernels' exact trick.
        A pre-placed DEVICE-RESIDENT [L, B] id batch (jax.Array, one
        document per column, OOV-0 padded) launches with no host staging
        at all.
        """
        if _is_device_array(docs):
            return self._count_many_device(docs)
        n = len(docs)
        if n == 0:
            return np.zeros(0, dtype=np.int64)
        t0 = time.perf_counter()
        k = (self._stepped.k
             if self._stepped is not None and self._mxu is None else 1)
        unit = 128 * k
        raws = self._raw_docs(docs)
        if raws is not None:
            docs_arrs, ent = raws
        else:
            docs_arrs, ent = [self.encode(d) for d in docs], None
        lengths = np.asarray([len(e) for e in docs_arrs], np.int64)
        out = np.zeros(n, dtype=np.int64)
        # Length-bucketed launches: documents are grouped by the pow2
        # multiple of ``unit`` covering their length, so one long outlier
        # no longer pads the WHOLE batch to its length (round-2 weakness:
        # a single 1M-symbol doc in a 1000-doc batch inflated the launch
        # ~1000x). Launch count is bounded by log2(longest/unit).
        with self._dispatch:
            for L, idx in self._length_buckets(lengths, unit):
                self._guard_acc(L)
                counts = self._count_many_launch(
                    [docs_arrs[i] for i in idx], L, ent)
                out[idx] = counts
        self._record("count_many" if ent is None else "count_many_raw",
                     int(lengths.sum()), time.perf_counter() - t0)
        return out

    def _raw_docs(self, docs):
        """Raw batch staging probe: every document must ride the SAME raw
        LUT (one kind per launch) and the active engine must have a raw
        batch kernel. Returns (list of raw arrays, lut entry) or None —
        host-encode fallback. For str documents on a codepoint LUT the
        wire width matches ids, but the host encode pass still leaves
        the critical path."""
        if not self._device_encode:
            return None
        st = self._stepped
        if self._mxu is None and st is not None and st.packed is None:
            return None  # unpacked two-table engine: no raw kernel
        out, ent0 = [], None
        for d in docs:
            r = self._raw_stream(d)
            if r is None:
                return None
            raw, ent = r
            if ent0 is None:
                ent0 = ent
            elif ent is not ent0:
                return None  # mixed byte/codepoint kinds in one batch
            out.append(raw)
        return (out, ent0) if out else None

    def _count_many_device(self, tm) -> np.ndarray:
        """Device-resident batch scoring (round 5): ``tm`` is a [L, B]
        jax.Array of letter ids, one document per column starting at the
        root, padded with the OOV id 0 (inert — reference modification
        [3]). No host staging, no per-call upload; serving pins steady
        batches once. Returns int64 counts [B]."""
        if tm.ndim != 2:
            raise ValueError(
                f"device-resident batch must be [L, B] (got {tm.ndim}-D)")
        if not jnp.issubdtype(tm.dtype, jnp.integer):
            raise ValueError(
                "device-resident batch must be integer letter ids "
                f"(got dtype {tm.dtype})")
        L, B = int(tm.shape[0]), int(tm.shape[1])
        t0 = time.perf_counter()
        if tm.dtype != jnp.int32:
            tm = tm.astype(jnp.int32)
        with self._dispatch:
            self._guard_acc(L)
            out = self._count_many_kernel(tm, L, B).astype(np.int64)
        self._record("count_many_device", L * B,
                     time.perf_counter() - t0)
        return out

    @staticmethod
    def _length_buckets(lengths: np.ndarray, unit: int):
        """Group document indices by the pow2-of-unit launch length
        covering them. Yields (L, indices) largest-first."""
        L_each = np.maximum(lengths, 1)  # empty docs ride the smallest bucket
        buckets = unit * (1 << np.maximum(
            0, np.ceil(np.log2(np.maximum(L_each / unit, 1))).astype(np.int64)))
        for L in np.unique(buckets)[::-1]:
            yield int(L), np.flatnonzero(buckets == L)

    def _split_for(self, L: int, n_cols: int, unit: int):
        """Per-document block split (round 5): a batch's parallelism is
        its column count, so a small batch of long documents left the
        chip latency-bound (a few long serial scans).
        Split each document into c blocks of Lp with intra-document halo
        warm-up (ops/scan_xla.split_docs_layout) so the launch reaches
        the stream path's width. Returns (c, Lp) with L <= c * Lp."""
        target = self._streams_for(L * max(n_cols, 1))
        c = min(-(-target // max(n_cols, 1)), max(L // unit, 1))
        if c <= 1:
            return 1, L
        Lp = -(-(-(-L // c)) // unit) * unit
        return -(-L // Lp), Lp

    def _count_many_launch(self, encoded, L: int, ent=None) -> np.ndarray:
        """One count_many device launch: every doc fits in L symbols.
        ``ent`` non-None = RAW staging (docs are raw symbol arrays; the
        LUT encodes per column inside the kernel — byte batches ship
        1 byte/symbol)."""
        n = len(encoded)
        B = -(-n // 8) * 8
        tm = np.zeros((L, B),
                      dtype=encoded[0].dtype if ent is not None
                      else np.int32)
        for j, e in enumerate(encoded):
            tm[:len(e), j] = e
        return self._count_many_kernel(jnp.asarray(tm), L, B,
                                       ent)[:n].astype(np.int64)

    def _count_many_kernel(self, tm, L: int, B: int, ent=None):
        """Dispatch one [L, B] batch (host-staged or device-resident)
        through the engine's count_many kernel with raw encode and
        per-document splitting as applicable. Returns np per-doc counts
        [B]."""
        raw = ent is not None
        st = self._stepped
        if self._mxu is not None:
            from ..ops import scan_mxu
            planes, cbits, n_planes, S_pad = self._mxu
            c, Lp = self._split_for(L, B, 128)
            fn = scan_mxu.make_mxu_count_many(
                self.V, S_pad, cbits, n_planes, self.halo, c, Lp, raw)
            per = (fn(planes, ent[0], tm) if raw else fn(planes, tm))
        elif st is not None and st.packed is not None and L % st.k == 0:
            from ..ops import multistep as ms
            c, Lp = self._split_for(L, B, 128 * st.k)
            fn = ms.make_stepped_count_many(
                st.V, st.k, st.Vk, st.count_bits, self._halo_steps,
                c, Lp, raw)
            per = (fn(self._st_dev[0], ent[0], tm) if raw
                   else fn(self._st_dev[0], tm))
        elif st is not None and st.packed is None and not raw \
                and L % st.k == 0:
            from ..ops import multistep as ms
            fn = ms.make_stepped_count_unpacked(st.V, st.k, st.Vk, 0)
            per = fn(*self._st_dev, tm)
        else:
            # dense-table core: also the exact fallback for resident
            # batches whose L is not a k-multiple
            from ..ops.scan_xla import make_blocked_count_many
            c, Lp = self._split_for(L, B, 128)
            fn = make_blocked_count_many(self.V, self.halo, c, Lp, raw)
            per = (fn(self._dflat, self._nb_out, ent[0], tm) if raw
                   else fn(self._dflat, self._nb_out, tm))
        return np.asarray(per)

    def _layout_stepped(self, ids: np.ndarray, head=None) -> np.ndarray:
        """Block layout for the k-stepped path: halo and block length both
        multiples of k so gram boundaries align."""
        k = self._stepped.k
        T = len(ids)
        B = self._streams_for(T)
        unit = 128 * k
        L = max(unit, -(-(-(-T // B)) // unit) * unit)
        blocks_tm, _ = blocking.block_time_major(ids, L, self._halo_sym,
                                                 head=head)
        return blocks_tm

    def find_matches(self, signs, offset: int = 0, head=None,
                     max_hits: Optional[int] = None):
        """All (event, Match) occurrences as a columnar ``MatchSet``
        (models/results.py) — list-compatible, with ends/starts/end_states/
        ranks as numpy arrays and lazy per-keyword Match materialization.
        Ordered by end position; within a position, longest first
        (reference acm_get_match index order).

        When the packed k-gram table exists (the default), retrieval runs
        at count-engine speed with AUTO-SIZED hit buffers: the scan phase
        returns the live-gram count, and a live gram holds at most k hit
        positions, so extraction buffers sized cap*k can never overflow —
        no ``max_hits`` needed. ``max_hits`` remains available to BOUND
        the result (device buffers and download scale with it; raises if
        more positions match — retry larger or chunk with a session), and
        is the only fast path for engines without a packed table."""
        from .results import MatchSet
        if max_hits is not None or self._prefilter != "off" or (
                self._stepped is not None
                and self._stepped.packed is not None
                and self._mxu is None):
            # Fast retrieval is the DEFAULT on prefilter scanners too
            # (VERDICT r4 #1): the no-arg call routes through the sparse/
            # elided bounded path with auto-sized buffers — sparse corpora
            # are the prefilter's reason to exist, so their default
            # retrieval must not be the full per-position decode.
            return self._find_matches_device(signs, offset, head, max_hits)
        states = self.scan_states(signs, head=head)
        ends, end_states, idx = decode_matches_arrays(states, self.tables,
                                                      offset)
        return MatchSet(self.machine, self.tables, ends, end_states, idx)

    def _find_matches_device(self, signs, offset, head, max_hits):
        from ..ops.hits import (make_blocked_hits_raw,
                                make_blocked_hits_stream,
                                make_stepped_hits_extract,
                                make_stepped_hits_extract_raw,
                                make_stepped_hits_scan,
                                make_stepped_hits_scan_raw)
        from .results import MatchSet
        if len(signs) == 0:
            return MatchSet(self.machine, self.tables,
                            np.zeros(0, np.int64), np.zeros(0, np.int32),
                            np.zeros(0, np.int32))
        t0 = time.perf_counter()
        raw = self._raw_stream(signs)
        if self._prefilter != "off":
            # max_hits None = AUTO here too: _sparse_hits sizes its hit
            # buffers from the live-block count (a live block holds at
            # most L_blk hit positions — structural, no user parameter).
            bound = None if max_hits is None else int(max_hits)
            if _is_device_array(signs):
                # Device-resident corpus (pinned in HBM): the block
                # filter runs ON DEVICE and retrieval gathers only live
                # windows — zero per-call corpus upload (VERDICT r4 #3).
                out = self._sparse_hits_device(signs, offset, head, bound)
            else:
                out = self._sparse_hits(signs, offset, head, bound,
                                        raw=raw)
            if out is not None:
                self._record("find_matches_sparse",
                             int(signs.shape[0])
                             if _is_device_array(signs) else len(signs),
                             time.perf_counter() - t0)
                return out
        # max_hits None = AUTO (stepped path only): buffers sized from the
        # scan phase's live-gram count — a live gram holds at most k hit
        # positions, so cap*k bounds extraction and overflow cannot occur.
        auto = max_hits is None
        if not auto:
            max_hits = int(max_hits)
        device_in = _is_device_array(signs)
        if device_in:
            import jax.numpy as _jnp
            if not _jnp.issubdtype(signs.dtype, _jnp.integer):
                raise ValueError(
                    "device-array input must be integer letter ids "
                    f"(got dtype {signs.dtype})")
        _guard_pos32(len(raw[0]) if raw is not None else
                     int(signs.shape[0]) if device_in else len(signs))
        with self._dispatch:
            # Engine state is read UNDER the dispatch lock: recalibrate()
            # may rebind engines concurrently, and the routing decision in
            # find_matches was made without the lock (review r4). When a
            # rebind lands an engine without a packed table under an auto
            # call, fall back to the full decode (exact, never raises).
            st = self._stepped
            # Retrieval at engine speed (VERDICT r3 #3): when the packed
            # k-gram table exists, the sequential leg is the count
            # kernel's one-gather-per-k-symbols scan; only live grams get
            # per-position refinement. The MXU small-automaton engine
            # keeps the dense core (its planes carry no position info,
            # and small automata are cheap either way).
            use_stepped = (st is not None and st.packed is not None
                           and self._mxu is None)
            if auto and not use_stepped:
                states = self.scan_states(signs, head=head)
                ends, end_states, idx = decode_matches_arrays(
                    states, self.tables, offset)
                return MatchSet(self.machine, self.tables, ends,
                                end_states, idx)
            if use_stepped:
                # Two-phase: the count-speed scan emits per-gram packed
                # (pre_state, count) words and a 4-byte live count; the
                # extract phase is compiled at a pow2 cap bucket of the
                # ACTUAL live-gram count, so refinement cost tracks the
                # corpus's match density, not the user's max_hits bound.
                if raw is not None:
                    ext, head_ids, B, L, T = self._stream_ext_raw(
                        raw[0], head, self._halo_sym, 128 * st.k)
                    # per-column int32 n_hits must not wrap (the auto
                    # sizing sums them — review r5): same bound as count
                    self._guard_acc(L)
                    scan_fn = make_stepped_hits_scan_raw(
                        st.V, st.k, st.Vk, st.count_bits, self._halo_steps,
                        B, L)
                    emit, n_hits_dev, n_live_dev = scan_fn(
                        self._st_dev[0], raw[1][0], ext, head_ids)
                else:
                    if device_in:
                        ext, B, L = self._ext_device(signs, head,
                                                     self._halo_sym,
                                                     128 * st.k)
                        T = int(signs.shape[0])
                    else:
                        ids = self.encode(signs)
                        ext, B, L, T = self._stream_ext(ids, head,
                                                        self._halo_sym,
                                                        128 * st.k)
                    self._guard_acc(L)
                    scan_fn = make_stepped_hits_scan(
                        st.V, st.k, st.Vk, st.count_bits, self._halo_steps,
                        B, L)
                    emit, n_hits_dev, n_live_dev = scan_fn(
                        self._st_dev[0], ext)
                n_live = int(n_live_dev)  # the one tiny host sync
                if not auto and n_live > max_hits:
                    raise ValueError(
                        f"at least {n_live} matching positions exceed "
                        f"max_hits={max_hits}; raise max_hits or chunk the "
                        "stream with a session")
                if n_live == 0:
                    positions = np.zeros(0, np.int64)
                    sts = np.zeros(0, np.int32)
                    n_hit_pos = 0
                else:
                    cap = max(8, 1 << (n_live - 1).bit_length())
                    if auto:
                        # n_hit_pos <= n_hits (phase A's exact match
                        # total), so this output bound cannot overflow
                        # and is tighter than cap*k on multi-match
                        # positions' corpora. Per-stream int32 counts
                        # combine in int64 here (two-level reduction).
                        n_hits = int(np.asarray(n_hits_dev)
                                     .sum(dtype=np.int64))
                        out_size = min(
                            cap * st.k,
                            max(8, 1 << (max(n_hits, 1) - 1).bit_length()))
                    else:
                        out_size = min(max_hits, cap * st.k)
                    # Density-adaptive phase B: past ~1/8 live grams the
                    # input-size-bound dense refinement beats the
                    # compaction path, whose cost scales with the live
                    # count (ops/hits.py).
                    pk1 = self._pk1()
                    n_grams = (B * L) // st.k
                    if pk1 is not None and n_live * 8 > n_grams:
                        from ..ops.hits import (
                            make_stepped_hits_extract_dense,
                            make_stepped_hits_extract_dense_raw)
                        if raw is not None:
                            ex_fn = make_stepped_hits_extract_dense_raw(
                                st.V, st.k, st.count_bits, pk1[1],
                                self._halo_steps, out_size, B, L)
                            positions, sts, n_hit_pos = ex_fn(
                                pk1[0], raw[1][0], ext, emit)
                        else:
                            ex_fn = make_stepped_hits_extract_dense(
                                st.V, st.k, st.count_bits, pk1[1],
                                self._halo_steps, out_size, B, L)
                            positions, sts, n_hit_pos = ex_fn(
                                pk1[0], ext, emit)
                    elif raw is not None:
                        ex_fn = make_stepped_hits_extract_raw(
                            st.V, st.k, st.count_bits, self._halo_steps,
                            cap, out_size, B, L)
                        positions, sts, n_hit_pos = ex_fn(
                            self._dflat, self._nb_out, raw[1][0], ext,
                            emit)
                    else:
                        ex_fn = make_stepped_hits_extract(
                            st.V, st.k, st.count_bits, self._halo_steps,
                            cap, out_size, B, L)
                        positions, sts, n_hit_pos = ex_fn(
                            self._dflat, self._nb_out, ext, emit)
            elif raw is not None:
                ext, head_ids, B, L, T = self._stream_ext_raw(
                    raw[0], head, self.halo, 128)
                fn = make_blocked_hits_raw(self.V, self.halo,
                                           max_hits, B, L)
                positions, sts, n_hits, n_hit_pos = fn(
                    self._dflat, self._nb_out, raw[1][0], ext, head_ids)
            else:
                if device_in:
                    ext, B, L = self._ext_device(signs, head, self.halo,
                                                 128)
                    T = int(signs.shape[0])
                else:
                    ids = self.encode(signs)
                    ext, B, L, T = self._stream_ext(ids, head, self.halo,
                                                    128)
                fn = make_blocked_hits_stream(self.V, self.halo,
                                              max_hits, B, L)
                positions, sts, n_hits, n_hit_pos = fn(self._dflat,
                                                       self._nb_out, ext)
            n_hit_pos = int(n_hit_pos)
            positions = np.asarray(positions)
            sts = np.asarray(sts)
        keep = (positions >= 0) & (positions < T)
        positions, sts = positions[keep], sts[keep]
        if not auto and n_hit_pos > max_hits:
            raise ValueError(
                f"{n_hit_pos} matching positions exceed max_hits={max_hits}; "
                "raise max_hits or chunk the stream with a session")
        # decode sparse hits through the emit CSR (columnar, O(hits) numpy)
        from ..ops.decode import expand_hits_arrays
        from .results import MatchSet
        order = np.argsort(positions, kind="stable")
        ends, end_states, idx = expand_hits_arrays(
            positions[order], sts[order], self.tables, offset)
        self._record("find_matches_device", T, time.perf_counter() - t0)
        return MatchSet(self.machine, self.tables, ends, end_states, idx)

    def _pk1(self):
        """Packed k=1 table ((next_state << cb1) | nb) for the dense
        extract variant of the stepped hits path — ONE gather per refined
        position instead of dflat + nb_out. Reuses the snapshot's own
        packed table when step_k == 1; otherwise built lazily (native
        threaded compose) and cached per table version (a refresh
        invalidates; retrieval-heavy serving re-pays one table build +
        upload per dictionary change). Returns (device_array, cb1) or
        None when (state_bits + cb1) exceeds the int32 packing."""
        st = self._stepped
        if st is not None and st.k == 1 and st.packed is not None:
            return self._st_dev[0], st.count_bits
        ver = self.tables.version
        c = getattr(self, "_pk1_cache", None)
        if c is not None and c[0] == ver:
            return c[1]
        cb1 = max(1, int(self._snap.max_nb).bit_length())
        state_bits = max(1, int(self.tables.n_states - 1).bit_length())
        entry = None
        if state_bits + cb1 <= 31:
            try:
                from ..core.native import compose_pack
                pk1 = compose_pack(self.tables.delta,
                                   self.tables.nb_outputs, 1, cb1)
            except Exception:
                d = self.tables.delta
                pk1 = ((d.astype(np.int64) << cb1)
                       | self.tables.nb_outputs[d]).astype(
                           np.int32).reshape(-1)
            entry = (jnp.asarray(pk1), cb1)
        self._pk1_cache = (ver, entry)
        return entry

    def _sparse_hits(self, signs, offset, head, max_hits, raw=None):
        """Filter-then-extract match retrieval (the sparse companion of
        _sparse_count): the host bandwidth pass marks live blocks, the
        device scans only their halo windows and returns bounded hit
        positions (ops/sparse.make_sparse_hits). Returns None when not
        profitable or not applicable — caller falls through to the dense
        bounded-hits kernel. Uses the dense-table halo (per-position
        states are required, so the packed k-gram core does not apply).

        ``max_hits=None`` = AUTO (round 5: the no-arg default on
        prefilter scanners): buffers size to n_live * L_blk — a live
        block holds at most L_blk matching positions, so overflow is
        structurally impossible and the overflow raise is skipped.

        Round 4: a raw input first tries the DEAD-BLOCK-ELIDED variant —
        filter over the raw bytes, upload only the live windows
        (ops/sparse.make_elided_hits) — the retrieval sibling of the
        elided count, so sparse retrieval also runs above the raw upload
        floor."""
        from ..ops import sparse
        halo = self.halo
        L_blk = 128
        if halo > L_blk:
            return None
        if raw is None:
            raw = self._raw_stream(signs)
        if raw is not None:
            verdict, live, n_live, nB_real = sparse.raw_elision_plan(
                raw[0], raw[1][3], raw[1][1], self._prefilter, halo,
                L_blk)
            if live is not None:
                self.stats["sparse_live_frac"] = n_live / max(nB_real, 1)
            if verdict == "zero":
                from .results import MatchSet
                return MatchSet(self.machine, self.tables,
                                np.zeros(0, np.int64),
                                np.zeros(0, np.int32),
                                np.zeros(0, np.int32))
            if verdict == "dense":
                return None  # dense bounded-hits kernels take it
            if verdict == "elide":
                return self._elided_hits(raw[0], (raw[1][3], raw[1][1]),
                                         len(raw[0]), live, n_live,
                                         offset, head, halo, L_blk,
                                         nB_real, max_hits)
        ids = self.encode(signs)
        T = len(ids)
        _guard_pos32(T)
        nB_real = -(-T // L_blk)
        live = sparse.live_blocks(ids, L_blk)
        n_live = int(live.sum())
        self.stats["sparse_live_frac"] = n_live / nB_real
        if n_live == 0:
            from .results import MatchSet
            e = np.zeros(0, np.int64)
            return MatchSet(self.machine, self.tables, e,
                            np.zeros(0, np.int32), np.zeros(0, np.int32))
        if self._prefilter == "auto" and n_live * 2 > nB_real:
            return None
        nB = 1 << (nB_real - 1).bit_length()
        cap = max(8, 1 << (n_live - 1).bit_length())
        auto = max_hits is None
        if auto:
            # Structural bound: every hit position lies in a live block.
            max_hits = max(8, 1 << (n_live * L_blk - 1).bit_length())
        n_ext = halo + (nB + 1) * L_blk
        with self._dispatch:
            key = ("sparse", n_ext)
            buf = self._ext_bufs.get(key) if self._reuse_buf else None
            if buf is None:
                buf = np.zeros(n_ext, np.int32)
                if self._reuse_buf:
                    self._ext_bufs[key] = buf
            buf[:halo] = 0
            if head is not None and len(head) and halo:
                h = min(len(head), halo)
                buf[halo - h:halo] = head[-h:]
            buf[halo:halo + T] = ids
            buf[halo + T:] = 0
            idx = np.full(cap, nB, np.int32)
            idx[:n_live] = np.flatnonzero(live)
            fn = sparse.make_sparse_hits(self.V, halo, L_blk, nB, cap,
                                         max_hits)
            positions, sts, n_hits, n_hit_pos = fn(
                self._dflat, self._nb_out, jnp.asarray(buf),
                jnp.asarray(idx))
            n_hit_pos = int(n_hit_pos)
            positions = np.asarray(positions)
            sts = np.asarray(sts)
        keep = (positions >= 0) & (positions < T)
        positions, sts = positions[keep], sts[keep]
        if not auto and n_hit_pos > max_hits:
            raise ValueError(
                f"{n_hit_pos} matching positions exceed max_hits="
                f"{max_hits}; raise max_hits or chunk the stream with a "
                "session")
        from ..ops.decode import expand_hits_arrays
        from .results import MatchSet
        ends, end_states, idx_out = expand_hits_arrays(
            positions, sts, self.tables, offset)
        return MatchSet(self.machine, self.tables, ends, end_states,
                        idx_out)

    def _sparse_hits_device(self, ids, offset, head, max_hits):
        """Filter-then-extract retrieval for DEVICE-RESIDENT corpora
        (round 5, VERDICT r4 #3): the live-block filter runs on device
        (ops/sparse.make_block_filter), one 4-byte sync picks the pow2
        capacity, and the windowed hits kernel consumes the resident
        order array — no host filter pass, no index upload, no corpus
        re-upload. ``max_hits=None`` = AUTO via the structural
        n_live * L_blk bound. Returns None when not applicable — caller
        falls through to the dense device-input kernels."""
        from ..ops import sparse
        from ..ops.decode import expand_hits_arrays
        from .results import MatchSet
        if not jnp.issubdtype(ids.dtype, jnp.integer):
            raise ValueError(
                "device-array input must be integer letter ids "
                f"(got dtype {ids.dtype})")
        halo = self.halo
        L_blk = 128
        if halo > L_blk:
            return None
        T = int(ids.shape[0])
        _guard_pos32(T)
        nB_real = -(-T // L_blk)
        nB = 1 << (nB_real - 1).bit_length()
        n_ext = halo + (nB + 1) * L_blk
        head_ids = np.zeros(halo, np.int32)
        if head is not None and len(head) and halo:
            h = min(len(head), halo)
            head_ids[halo - h:] = head[-h:]
        with self._dispatch:
            ext = jnp.concatenate([
                jnp.asarray(head_ids),
                ids.astype(jnp.int32) if ids.dtype != jnp.int32 else ids,
                jnp.zeros(n_ext - halo - T, jnp.int32)])
            order, n_live_dev = sparse.make_block_filter(
                nB, L_blk, halo)(ext)
            n_live = int(n_live_dev)  # the one tiny host sync
            self.stats["sparse_live_frac"] = n_live / max(nB_real, 1)
            if n_live == 0:
                return MatchSet(self.machine, self.tables,
                                np.zeros(0, np.int64),
                                np.zeros(0, np.int32),
                                np.zeros(0, np.int32))
            if self._prefilter == "auto" and n_live * 2 > nB_real:
                return None
            cap = min(nB, max(8, 1 << (n_live - 1).bit_length()))
            auto = max_hits is None
            if auto:
                max_hits = max(8, 1 << (n_live * L_blk - 1).bit_length())
            fn = sparse.make_sparse_hits_dev(self.V, halo, L_blk, nB,
                                             cap, int(max_hits))
            positions, sts, n_hits, n_hit_pos = fn(
                self._dflat, self._nb_out, ext, order, n_live_dev)
            n_hit_pos = int(n_hit_pos)
            positions = np.asarray(positions)
            sts = np.asarray(sts)
        keep = (positions >= 0) & (positions < T)
        positions, sts = positions[keep], sts[keep]
        if not auto and n_hit_pos > max_hits:
            raise ValueError(
                f"{n_hit_pos} matching positions exceed max_hits="
                f"{max_hits}; raise max_hits or chunk the stream with a "
                "session")
        ends, end_states, idx_out = expand_hits_arrays(
            positions, sts, self.tables, offset)
        return MatchSet(self.machine, self.tables, ends, end_states,
                        idx_out)

    def _elided_hits(self, arr, lut, T: int, live, n_live: int, offset,
                     head, halo: int, L_blk: int, nB_real: int,
                     max_hits):
        """Bounded hits over host-elided live windows: only the live
        windows upload (ops/sparse.elide_windows + make_elided_hits);
        positions recover from the uploaded block indices.
        ``max_hits=None`` = AUTO: buffers size to the structural
        n_live * L_blk bound (no overflow possible, no raise)."""
        from ..ops import sparse
        from ..ops.decode import expand_hits_arrays
        from .results import MatchSet
        _guard_pos32(T)
        auto = max_hits is None
        if auto:
            max_hits = max(8, 1 << (n_live * L_blk - 1).bit_length())
        with self._dispatch:
            tm, idx = sparse.elide_windows(arr, lut, T, live, n_live,
                                           head, halo, L_blk, nB_real)
            fn = sparse.make_elided_hits(self.V, halo, L_blk,
                                         int(max_hits))
            positions, sts, n_hits, n_hit_pos = fn(
                self._dflat, self._nb_out, jnp.asarray(tm),
                jnp.asarray(idx.astype(np.int32)))
            n_hit_pos = int(n_hit_pos)
            positions = np.asarray(positions)
            sts = np.asarray(sts)
        keep = (positions >= 0) & (positions < T)
        positions, sts = positions[keep], sts[keep]
        if not auto and n_hit_pos > max_hits:
            raise ValueError(
                f"{n_hit_pos} matching positions exceed max_hits="
                f"{max_hits}; raise max_hits or chunk the stream with a "
                "session")
        self.stats["sparse_elided_upload_bytes"] = int(tm.nbytes)
        ends, end_states, idx_out = expand_hits_arrays(
            positions, sts, self.tables, offset)
        return MatchSet(self.machine, self.tables, ends, end_states,
                        idx_out)

    def _record(self, op: str, n_symbols: int, seconds: float) -> None:
        self.stats["last_op"] = op
        self.stats["last_symbols"] = n_symbols
        self.stats["last_seconds"] = seconds
        self.stats["last_symbols_per_sec"] = (
            n_symbols / seconds if seconds > 0 else float("inf"))
        self.stats["total_symbols"] = (
            self.stats.get("total_symbols", 0) + n_symbols)

    def session(self) -> "StreamSession":
        """Open a chunked streaming session (exact across chunk edges)."""
        return StreamSession(self)

    # -- conformance oracle -------------------------------------------------

    def scan_states_sequential(self, signs) -> np.ndarray:
        """Single-stream lax.scan — the literal reference recurrence, used to
        validate the blocked path."""
        ids = self.encode(signs)
        if len(ids) == 0:
            return np.zeros(0, dtype=np.int32)
        _, states = self._seq_scan(self._dflat, jnp.asarray(ids),
                                   jnp.int32(0))
        return np.asarray(states)


class StreamSession:
    """Chunked streaming scan with exact continuity across chunk edges.

    The reference streams one symbol per acm_match call with an O(1) cursor
    (c:433-448); the device equivalent streams a *chunk* per call, carrying the
    last halo symbols of the previous chunk so matches spanning chunk edges
    are found exactly. This is also the scan-resume story (SURVEY.md §5):
    a session checkpoint is (offset, tail ids), both tiny and exact.
    """

    def __init__(self, scanner: DenseScanner):
        self.scanner = scanner
        self.offset = 0
        self.total = 0
        self._tail = np.zeros(0, dtype=np.int32)

    @property
    def _hmax(self) -> int:
        # Read live (not pinned at construction): scanner.refresh() between
        # feeds may grow the halo with the dictionary, and subsequent tails
        # must keep up. A chunk fed right after such a growth carries the
        # shorter previous tail — matches reaching further back than the
        # *previous* snapshot's halo resolve from the root, the documented
        # snapshot semantics for insert-during-scan.
        s = self.scanner
        return max(s.halo, s._halo_sym if s._stepped is not None else 0)

    def _advance(self, signs) -> np.ndarray:
        """Record the chunk: return the PREVIOUS tail (the head carry for
        this chunk's scan) and keep the new tail. Only the last ``hmax``
        symbols are host-encoded — the chunk body rides whichever encode
        path the scanner picks (raw device-side for bytes/str)."""
        head = self._tail
        hmax = self._hmax
        n = len(signs)
        if hmax and n:
            tail_ids = np.asarray(self.scanner.encode(signs[-hmax:]),
                                  np.int32)
            joined = (np.concatenate([self._tail, tail_ids])
                      if len(self._tail) else tail_ids)
            self._tail = joined[-hmax:]
        elif not hmax:
            self._tail = self._tail[:0]
        self.offset += n
        return head

    def feed_count(self, signs) -> int:
        """Count matches in the next chunk (including matches spanning the
        previous chunk edge, attributed to this chunk)."""
        head = self._advance(signs)
        n = self.scanner.count(signs, head=head) if len(signs) else 0
        self.total += n
        return n

    def feed_matches(self, signs, max_hits: Optional[int] = None):
        """Match events in the next chunk, with absolute stream positions.

        ``max_hits``: route the chunk through the bounded-hits fast path
        (packed k-gram scan + hit extraction — only hit positions travel)
        instead of full per-position decode; raises if the chunk holds
        more matching positions, same contract as
        DenseScanner.find_matches."""
        offset = self.offset
        head = self._advance(signs)
        if not len(signs):
            # Same columnar type as every other retrieval (an empty chunk
            # must still expose .ends/.starts — review r4 missed this one
            # empty-return site).
            from .results import MatchSet
            s = self.scanner
            return MatchSet(s.machine, s.tables, np.zeros(0, np.int64),
                            np.zeros(0, np.int32), np.zeros(0, np.int32))
        kw = {}
        if max_hits is not None:
            # mesh scanners bound hits per shard; single-chip per chunk
            key = ("max_hits_per_shard" if hasattr(self.scanner, "n_dev")
                   else "max_hits")
            kw[key] = max_hits
        out = self.scanner.find_matches(signs, offset=offset, head=head,
                                        **kw)
        self.total += len(out)
        return out

    # -- resume -----------------------------------------------------------

    def checkpoint(self) -> dict:
        return {"offset": self.offset, "tail": self._tail.copy(),
                "total": self.total, "version": self.scanner.version}

    @classmethod
    def restore(cls, scanner: DenseScanner, state: dict) -> "StreamSession":
        if state["version"] != scanner.version:
            raise ValueError("session checkpoint belongs to a different "
                             "table snapshot")
        s = cls(scanner)
        s.offset = int(state["offset"])
        s._tail = np.asarray(state["tail"], np.int32)
        s.total = int(state["total"])
        return s
