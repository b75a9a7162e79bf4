"""Retrieval-vs-count ratio at realistic match density (VERDICT r3 #3).

The headline corpus (bench_matches.py) is match-dense — about one match
per 7 bytes — which makes ANY retrieval pay ~10 gather/scatter passes over
16M+ element buffers (see ops/hits.py). This bench measures the
production serving shape instead: 1000 byte keywords, ~30k matches in a
64 MB corpus (0.04% of positions), where the sequential leg of
find_matches(max_hits=...) is literally the count kernel.

Prints one JSON line.
"""

from __future__ import annotations

import json
import time

import numpy as np


def main() -> None:
    import aho_corasick_1975_tpu as ac

    rng = np.random.default_rng(3)
    m = ac.Machine()
    words = ["".join(chr(97 + c) for c in rng.integers(0, 26,
                                                       rng.integers(5, 9)))
             for _ in range(1000)]
    for w in words:
        m.insert_keyword(b" " + w.encode() + b" ")
    sc = m.scanner(n_streams=16384)

    T = 64 << 20
    base = rng.integers(97, 123, T, dtype=np.uint8)
    base[rng.integers(0, T, T // 200)] = 32
    arr = bytearray(base.tobytes())
    for _ in range(30_000):
        w = (" " + words[rng.integers(0, len(words))] + " ").encode()
        p = int(rng.integers(0, T - 20))
        arr[p:p + len(w)] = w
    ids = np.asarray(m.vocab.lookup_many(bytes(arr)), np.int32)

    n = sc.count(ids)
    tc = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        sc.count(ids)
        tc = min(tc, time.perf_counter() - t0)

    max_hits = 1 << 17
    ms = sc.find_matches(ids, max_hits=max_hits)
    assert len(ms) == n
    th = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        ms = sc.find_matches(ids, max_hits=max_hits)
        _ = ms.starts
        th = min(th, time.perf_counter() - t0)

    # No-argument AUTO default (round 5): buffers sized from the scan
    # phase's own counters — must land within noise of the explicit
    # bound above.
    ms = sc.find_matches(ids)
    assert len(ms) == n
    ta = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        ms = sc.find_matches(ids)
        _ = ms.starts
        ta = min(ta, time.perf_counter() - t0)

    # Prefilter scanner, raw bytes, NO ARGUMENTS (the VERDICT r4 #1 done
    # bar): the default must ride the sparse/elided bounded path.
    raw = bytes(arr)
    sp = m.scanner(n_streams=16384, prefilter="on")
    ms = sp.find_matches(raw)
    assert sp.stats["last_op"] == "find_matches_sparse", sp.stats
    assert len(ms) == n
    tsp = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        ms = sp.find_matches(raw)
        _ = ms.starts
        tsp = min(tsp, time.perf_counter() - t0)
    ms = sp.find_matches(raw, max_hits=max_hits)
    assert len(ms) == n
    tspb = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        ms = sp.find_matches(raw, max_hits=max_hits)
        _ = ms.starts
        tspb = min(tspb, time.perf_counter() - t0)

    print(json.dumps({
        "metric": "retrieval_vs_count_realistic_density",
        "value": round(th / tc, 2),
        "unit": "find_matches wall / count wall",
        "vs_baseline": None,
        "detail": {
            "matches": int(n), "corpus_bytes": T,
            "density_pct": round(n / T * 100, 4),
            "count_wall_s": round(tc, 3),
            "find_matches_wall_s": round(th, 3),
            "find_matches_auto_wall_s": round(ta, 3),
            "auto_vs_explicit": round(ta / th, 2),
            "prefilter_noarg_raw_wall_s": round(tsp, 3),
            "prefilter_explicit_raw_wall_s": round(tspb, 3),
            "prefilter_noarg_vs_explicit": round(tsp / tspb, 2),
            "hits_kernel": "stepped two-phase (compact extract)",
        },
    }))


if __name__ == "__main__":
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    main()
