"""Count-engine choice: the ``engine="auto"`` rule and the on-device probe.

``auto_engine`` is the one rule both scanners (models/scanner.py and
parallel/sharded_scan.py) resolve ``engine="auto"`` through. It decides from
the backend and the automaton's padded state count alone, and picks the
MXU-style digit-matmul engine (ops/scan_mxu.py) or the hybrid gather+matmul
engine (ops/scan_hybrid.py) only inside an envelope where a card of that
backend measured it faster end to end than the packed gather
(``AUTO_ENVELOPES``); everywhere else it picks the gather.

``DenseScanner(calibrate=True)`` replaces the rule with a measurement: each
available engine runs the PRODUCTION count path on a synthetic corpus once,
the fastest wins, and the choice is cached — in-process and in a small JSON
file keyed by (backend, device kind, automaton geometry) — so later
processes skip the probe entirely.

The probe corpus is uniform random ids over the automaton's own vocabulary
(the engines' relative order is shape-dominated; hot-state locality shifts
the crossover point, which is why the cached choice is per-geometry and
re-measurable by deleting the cache file).
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from typing import Dict, Optional, Tuple

_MEM: Dict[str, str] = {}
_LOCK = threading.Lock()

# Where a card measured an engine faster end to end than the packed gather:
# backend -> {engine: largest padded state count}. Empty for a backend
# means "auto" always resolves to the gather there. On an NVIDIA H100 80GB
# HBM3 at a 400 W power limit (chip_smoke.py phase 6) the gather won at
# both sizes measured: 256 padded states (gather 0.013 s per 64 MiB pass,
# hybrid 0.052 s, mxu 0.068 s) and 4,480 (gather 0.018 s, hybrid 0.075 s).
AUTO_ENVELOPES: Dict[str, Dict[str, int]] = {}


def auto_engine(backend: str, s_pad: int, has_packed: bool) -> str:
    """The count engine ``engine="auto"`` resolves to on ``backend`` for an
    automaton of ``s_pad`` padded states (ops/scan_mxu.padded_states);
    ``has_packed``: the snapshot holds a packed stepped table, which the
    hybrid engine's gather half needs."""
    env = AUTO_ENVELOPES.get(backend, {})
    if s_pad <= env.get("mxu", 0):
        return "mxu"
    if has_packed and s_pad <= env.get("hybrid", 0):
        return "hybrid"
    return "gather"


def resolve_engine(engine: str, tables, stepped, place,
                   backend: Optional[str] = None
                   ) -> Tuple[Optional[tuple], Optional[tuple]]:
    """Bind the count engine for a snapshot: returns (mxu, hybrid), at most
    one of them set to (device planes, count_bits, n_planes, S_pad); both
    None means the gather engines. ``place`` uploads the host planes. An
    explicit "mxu"/"hybrid" that the automaton does not fit raises
    ValueError; "auto" (``auto_engine``) falls back to the gather."""
    from . import scan_hybrid, scan_mxu
    has_packed = stepped is not None and stepped.packed is not None
    want = engine
    if engine == "auto":
        if backend is None:
            import jax
            backend = jax.default_backend()
        want = auto_engine(backend,
                           scan_mxu.padded_states(tables.n_states),
                           has_packed)
    if want == "mxu":
        built = scan_mxu.build_planes(tables.delta, tables.nb_outputs)
        if built is not None:
            return (place(built[0]),) + tuple(built[1:]), None
        if engine == "mxu":
            raise ValueError(
                "automaton too large for the MXU engine (padded states "
                "or digit planes over the ops/scan_mxu.py limits); use "
                "engine='gather'")
    if want == "hybrid":
        built = (scan_mxu.build_planes(
            tables.delta, tables.nb_outputs,
            max_states=scan_hybrid.MAX_HYBRID_STATES)
            if has_packed else None)
        if built is not None:
            return None, (place(built[0]),) + tuple(built[1:])
        if engine == "hybrid":
            raise ValueError(
                "automaton too large for the hybrid engine (padded "
                "states over ops/scan_hybrid.MAX_HYBRID_STATES, or no "
                "packed stepped table); use engine='gather'")
    return None, None


def engine_candidates(tables, stepped) -> list:
    """Engines the automaton fits, gather first (the calibration probe's
    candidates)."""
    from . import scan_hybrid, scan_mxu
    out = ["gather"]
    if scan_mxu.build_planes(tables.delta, tables.nb_outputs) is not None:
        out.append("mxu")
    if (stepped is not None and stepped.packed is not None
            and scan_mxu.build_planes(
                tables.delta, tables.nb_outputs,
                max_states=scan_hybrid.MAX_HYBRID_STATES) is not None):
        out.append("hybrid")
    return out


def cache_path() -> str:
    return os.environ.get(
        "ACX_AUTOTUNE_CACHE",
        os.path.join(tempfile.gettempdir(), "acx_autotune.json"))


def geometry_key(n_states: int, V: int, step_k: int) -> str:
    import jax
    dev = jax.devices()[0]
    s_bucket = 1 << max(0, int(n_states - 1).bit_length())  # pow2 bucket
    return "|".join([jax.default_backend(),
                     getattr(dev, "device_kind", "unknown"),
                     f"S{s_bucket}", f"V{V}", f"k{step_k}"])


def cached_choice(key: str) -> Optional[str]:
    with _LOCK:
        if key in _MEM:
            return _MEM[key]
        try:
            with open(cache_path()) as f:
                disk = json.load(f)
        except (OSError, ValueError):
            return None
        _MEM.update(disk)
        return _MEM.get(key)


def store_choice(key: str, engine: str) -> None:
    with _LOCK:
        _MEM[key] = engine
        path = cache_path()
        try:
            try:
                with open(path) as f:
                    disk = json.load(f)
            except (OSError, ValueError):
                disk = {}
            disk[key] = engine
            tmp = path + f".{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump(disk, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except OSError:
            pass  # cache file is an optimization, never a failure


def probe(scanner, candidates, probe_symbols: int = 1 << 21,
          reps: int = 2) -> str:
    """Measure the production count() of each candidate engine on a
    synthetic random corpus; return the fastest engine name. The scanner
    is rebound per candidate and left on the winner by the caller.

    Holds the scanner's dispatch lock (when it has one) for the whole
    probe: rebinding ``_engine``/kernels must not interleave with a live
    scan on another thread (VERDICT r3 #7 — previously safe only because
    calibration was constructor-driven). The lock is reentrant, so the
    probe's own count() calls re-acquire it without deadlock."""
    import contextlib

    import numpy as np
    lock = getattr(scanner, "_dispatch", None)
    with (lock if lock is not None else contextlib.nullcontext()):
        rng = np.random.default_rng(0)
        ids = rng.integers(0, scanner.V, size=probe_symbols, dtype=np.int32)
        timings = {}
        for name in candidates:
            scanner._engine = name
            scanner._bind_kernels()
            scanner.count(ids)  # compile + warm
            best = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                scanner.count(ids)
                best = min(best, time.perf_counter() - t0)
            timings[name] = best
        winner = min(timings, key=timings.get)
        scanner.stats["calibration"] = {k: round(v, 5)
                                        for k, v in timings.items()}
        return winner
