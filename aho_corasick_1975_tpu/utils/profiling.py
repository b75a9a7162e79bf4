"""Tracing / profiling helpers (SURVEY.md §5 "Tracing / profiling").

The reference's only instrumentation is harness-level clock() timing
(generic_test.c:61,182,...). Here:

* ``phase_timer`` — structured wall-clock phases (build / compile / upload /
  scan / decode) accumulated into a dict, the per-phase breakdown the
  BASELINE methodology asks for;
* ``device_trace`` — a jax.profiler trace context for XLA device traces
  around any scan call;
* timing note: JAX dispatches asynchronously, so a timed phase must end in
  ``jax.block_until_ready`` on its outputs (or a host read of them, which
  is what scanner.stats records).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator


class PhaseTimer:
    def __init__(self):
        self.seconds: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] += time.perf_counter() - t0
            self.calls[name] += 1

    def report(self) -> Dict[str, dict]:
        return {k: {"seconds": round(v, 6), "calls": self.calls[k]}
                for k, v in sorted(self.seconds.items())}


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[None]:
    """jax.profiler trace around a block (view in TensorBoard/XProf)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
