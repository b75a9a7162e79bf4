"""End-to-end sparse scan ABOVE the upload floor (VERDICT r3 stretch #8).

The end-to-end ceiling for dense corpora is the host->device transfer
(e2e ~= the device_put floor). For SPARSE corpora the round-4 dead-block
elision breaks that ceiling: the host filter pass marks live 128-symbol
blocks, the compacted live windows are
gathered on host and ONLY they upload — wire bytes = live fraction x
corpus — before the standard count core runs on the windows. This bench
measures end-to-end count() from raw host bytes on a 256 MB sparse corpus
vs the synchronously-timed device_put floor for the same bytes.

Prints one JSON line.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

KEYWORDS = [b"needle", b"haystack", b"signature", b"marker", b"beacon",
            b"sentinel", b"flagged", b"tracer"]
N = 256 << 20
DENSITY = 1e-3


def main() -> None:
    import jax.numpy as jnp

    import aho_corasick_1975_tpu as ac

    m = ac.Machine()
    for kw in KEYWORDS:
        m.insert_keyword(kw)

    rng = np.random.default_rng(7)
    corpus = np.zeros(N, np.uint8)  # 0x00 = OOV everywhere
    n_plants = int(N * DENSITY / 8)
    starts = rng.integers(0, N - 16, n_plants)
    for i in range(0, n_plants, 50_000):  # chunked host writes
        for s in starts[i:i + 50_000]:
            kw = KEYWORDS[int(s) % len(KEYWORDS)]
            corpus[s:s + len(kw)] = np.frombuffer(kw, np.uint8)
    corpus_b = corpus.tobytes()

    sc = m.scanner(n_streams=4096, prefilter="on")
    total = sc.count(corpus_b)
    _, oracle = m._b.match_bulk(0, np.asarray(m.vocab.lookup_many(corpus_b),
                                              np.int32))
    assert total == oracle, (total, oracle)
    te = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        sc.count(corpus_b)
        te = min(te, time.perf_counter() - t0)

    # Retrieval leg: elided bounded hits (round 4) — full MatchSet out.
    ms = sc.find_matches(corpus_b, max_hits=1 << 17)
    assert len(ms) == total
    tr = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        ms = sc.find_matches(corpus_b, max_hits=1 << 17)
        _ = ms.starts
        tr = min(tr, time.perf_counter() - t0)

    # Raw upload floor for the SAME bytes (block_until_ready per rep).
    import jax
    raw = np.frombuffer(corpus_b, np.uint8)
    jax.block_until_ready(jnp.asarray(raw))
    tu = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        jax.block_until_ready(jnp.asarray(raw))
        tu = min(tu, time.perf_counter() - t0)

    print(json.dumps({
        "metric": "sparse_e2e_vs_upload_floor",
        "value": round(N / te / 1e6, 1),
        "unit": "MB/s end-to-end from host bytes",
        "vs_baseline": None,
        "detail": {
            "corpus_bytes": N, "density": DENSITY,
            "matches": int(total),
            "e2e_seconds": round(te, 3),
            "upload_floor_mb_per_sec": round(N / tu / 1e6, 1),
            "e2e_over_upload_floor": round(tu / te, 2),
            "elided_upload_bytes": sc.stats.get(
                "sparse_elided_upload_bytes"),
            "live_frac": round(sc.stats.get("sparse_live_frac", -1), 5),
            "find_matches_e2e_mb_per_sec": round(N / tr / 1e6, 1),
            "find_matches_over_upload_floor": round(tu / tr, 2),
        },
    }))


if __name__ == "__main__":
    main()
