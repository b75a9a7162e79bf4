"""Batch scoring throughput (count_many) at config-3 scale (VERDICT r4
weak #8 / next #6): 10k keywords, ~100 MB of ASCII byte documents.

Legs:
* raw      — round-5 default: batch staged as raw bytes (1 byte/symbol,
             4x less wire than the id path), vocab encode in-kernel.
* id path  — the pre-round-5 behavior (device_encode=False): host encode
             pass + int32 upload.
* resident — pre-placed [L, B] device batch (serving pins steady
             batches): pure scan rate, no wire at all.

Run alone on a GPU (one process per card). Prints one JSON line; writes
results_count_many.json.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_KW = 10_000
N_DOCS = 256
DOC_LEN = 400_000          # ~100 MB total
REPS = 3


def main() -> None:
    import jax.numpy as jnp

    import aho_corasick_1975_tpu as ac

    rng = np.random.default_rng(0)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz ", np.uint8)
    m = ac.ByteMachine()
    seen = set()
    while len(seen) < N_KW:
        w = bytes(rng.choice(letters[:-1], rng.integers(4, 10)))
        if w not in seen:
            seen.add(w)
            m.insert_keyword(b" " + w + b" ")
    docs = [bytes(rng.choice(letters, DOC_LEN)) for _ in range(N_DOCS)]
    total_bytes = sum(len(d) for d in docs)

    def timed(fn):
        fn()                               # warm-up / compile
        best = float("inf")
        for _ in range(REPS):
            t0 = time.perf_counter()
            r = fn()
            best = min(best, time.perf_counter() - t0)
        return best, r

    sc = m.scanner(n_streams=16384)
    t_raw, c_raw = timed(lambda: sc.count_many(docs))
    assert sc.stats["last_op"] == "count_many_raw"

    sc_id = m.scanner(n_streams=16384, device_encode=False)
    t_id, c_id = timed(lambda: sc_id.count_many(docs))
    assert sc_id.stats["last_op"] == "count_many"
    np.testing.assert_array_equal(c_raw, c_id)

    # resident batch: one [L, B] id array pinned once
    k = sc._stepped.k if sc._stepped is not None and sc._mxu is None else 1
    L = -(-DOC_LEN // (128 * k)) * (128 * k)
    tm = np.zeros((L, N_DOCS), np.int32)
    for j, d in enumerate(docs):
        ids = sc.encode(d)
        tm[:len(ids), j] = ids
    placed = jnp.asarray(tm)
    t_res, c_res = timed(lambda: sc.count_many(placed))
    np.testing.assert_array_equal(c_res, c_raw)

    out = {
        "metric": "count_many_throughput_config3",
        "corpus_bytes": total_bytes,
        "n_docs": N_DOCS,
        "n_keywords": N_KW,
        "raw_mb_s": round(total_bytes / t_raw / 1e6, 1),
        "id_path_mb_s": round(total_bytes / t_id / 1e6, 1),
        "device_resident_mb_s": round(total_bytes / t_res / 1e6, 1),
        "raw_vs_id_speedup": round(t_id / t_raw, 2),
        "wire_bytes_raw": total_bytes,
        "wire_bytes_id": total_bytes * 4,
    }
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "results_count_many.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
