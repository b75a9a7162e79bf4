"""Settle the e2e-above-the-floor claim with variance data (VERDICT r4
weak #3 / next #4).

Does the pipelined raw e2e count beat the sequentially-measured
device_put floor? Host<->device transfer rates vary run to run, so single
samples cannot adjudicate. This script:

1. runs the pipelined raw e2e count and the device_put floor
   INTERLEAVED, N times each (both legs see the same transfer weather);
2. sweeps the pipeline chunk size (the one depth knob,
   DenseScanner._pipeline_chunk) to check whether a different depth
   recovers overlap;
3. writes mean/min/max per leg to results_e2e_variance.json.

Headline config (bench.py): the seeded 64 MiB Zipfian corpus of
utils/corpus.py, 1000-keyword dictionary, raw byte path. Run alone on a
GPU (one process per card).
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N = int(os.environ.get("E2E_N", "10"))
SWEEP = [2 << 20, 4 << 20, 8 << 20, 16 << 20]


def build():
    import aho_corasick_1975_tpu as ac
    from aho_corasick_1975_tpu.utils import corpus
    corp = corpus.generate(64 << 20)
    m = ac.Machine()
    for w in corp.keywords:
        m.insert_keyword(b" " + w + b" ")
    return m, corp.text


def main() -> None:
    import jax
    import jax.numpy as jnp

    m, text = build()
    sc = m.scanner(n_streams=16384)
    raw = np.frombuffer(text, np.uint8)
    nb = len(text)

    # warm both legs (compile + first transfer)
    total = sc.count(text)
    assert sc.count(text) == total
    jax.block_until_ready(jnp.asarray(raw))

    e2e, floor = [], []
    for i in range(N):
        t0 = time.perf_counter()
        assert sc.count(text) == total
        e2e.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        jax.block_until_ready(jnp.asarray(raw))
        floor.append(time.perf_counter() - t0)
        print(f"  pass {i}: e2e {nb/e2e[-1]/1e6:.1f} MB/s, "
              f"floor {nb/floor[-1]/1e6:.1f} MB/s", file=sys.stderr)

    def stats(ts):
        rates = [nb / t / 1e6 for t in ts]
        return {"mean_mb_s": round(statistics.mean(rates), 1),
                "min_mb_s": round(min(rates), 1),
                "max_mb_s": round(max(rates), 1),
                "n": len(rates)}

    sweep = {}
    saved = sc._pipeline_chunk
    for C in SWEEP:
        sc._pipeline_chunk = C
        assert sc.count(text) == total      # compile this geometry
        ts = []
        for _ in range(4):
            t0 = time.perf_counter()
            sc.count(text)
            ts.append(time.perf_counter() - t0)
        sweep[str(C >> 20) + "M"] = stats(ts)
        print(f"  chunk {C >> 20}M: {sweep[str(C >> 20) + 'M']}",
              file=sys.stderr)
    sc._pipeline_chunk = saved

    out = {
        "metric": "e2e_vs_upload_floor_variance",
        "corpus_bytes": nb,
        "interleaved_passes": N,
        "e2e_pipelined_raw": stats(e2e),
        "device_put_floor": stats(floor),
        "chunk_sweep_e2e": sweep,
        "verdict_e2e_minus_floor_mean_mb_s": round(
            statistics.mean([nb / t / 1e6 for t in e2e])
            - statistics.mean([nb / t / 1e6 for t in floor]), 1),
    }
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "results_e2e_variance.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
