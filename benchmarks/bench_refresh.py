"""Online-insertion turnaround: DenseScanner.refresh vs fresh construction.

BASELINE config-5 shape: 10k random 7-char keywords live, then 1k more
registered online (Meyer mode). Measures how fast the device snapshot
catches up, which is the serving-side cost of the reference's
insert-during-scan feature (README.md:352-356) under the device snapshot
consistency model.

Run: timeout 560 python benchmarks/bench_refresh.py
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def kw(rng, n):
    return "".join(chr(ord("a") + c) for c in rng.integers(0, 26, n))


def main() -> None:
    import aho_corasick_1975_tpu as ac

    rng = np.random.default_rng(42)
    base = [kw(rng, 7) for _ in range(10_000)]
    online = [kw(rng, 7) for _ in range(1_000)]
    text = "".join(kw(rng, 1) for _ in range(1_000_000))

    m = ac.Machine()
    for w in base:
        m.insert_keyword(w)

    budget = 512 * 1024 * 1024  # admits k=2 at this state count
    t0 = time.perf_counter()
    sc = m.scanner(n_streams=8192, step_budget_bytes=budget)
    n0 = sc.count(text)  # forces compile + upload end-to-end
    t_construct = time.perf_counter() - t0
    print(f"fresh scanner + first count: {t_construct:.3f}s "
          f"(S={m.n_states}, k={sc.step_k}, matches={n0})", flush=True)

    # Serving case: a few keywords registered online, snapshot catch-up.
    for i in range(6):
        for w in online[i * 10:(i + 1) * 10]:
            m.insert_keyword(w)
        t0 = time.perf_counter()
        ok = sc.refresh()
        dt = time.perf_counter() - t0
        print(f"+10 keywords refresh #{i}: {dt*1e3:7.1f} ms in_place={ok} "
              f"(rows={sc.stats.get('refresh_rows')}, "
              f"cells={sc.stats.get('refresh_cells')})",
              flush=True)

    # Bulk case: the remaining ~1k at once (expected to fall back).
    t0 = time.perf_counter()
    for w in online[60:]:
        m.insert_keyword(w)
    t_insert = time.perf_counter() - t0

    t0 = time.perf_counter()
    in_place = sc.refresh()
    t_refresh = time.perf_counter() - t0
    n1 = sc.count(text)

    t0 = time.perf_counter()
    fresh = m.scanner(n_streams=8192, step_budget_bytes=budget)
    n2 = fresh.count(text)
    t_fresh = time.perf_counter() - t0
    assert n1 == n2, (n1, n2)

    print(f"1k online inserts (host Meyer): {t_insert*1e3:.1f} ms")
    print(f"refresh() in-place={in_place}: {t_refresh*1e3:.1f} ms "
          f"(rows={sc.stats.get('refresh_rows')}, "
          f"cells={sc.stats.get('refresh_cells')})")
    print(f"fresh scanner + count (the old turnaround): {t_fresh:.3f}s")
    print(f"turnaround speedup: {t_fresh / max(t_refresh, 1e-9):.1f}x")


if __name__ == "__main__":
    main()
