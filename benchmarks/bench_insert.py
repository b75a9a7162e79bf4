"""Dictionary construction (insert) throughput.

Reference baseline (README.md:366-367): 370,099 keywords / 3,864,776 chars
registered in 0.92 s (~4.2 MB/s, the reference's own figure) on unspecified
hardware. This benchmark reproduces that scale with the reference Test-3
shape (random fixed-length keywords over a 26-letter alphabet,
generic_test.c:252-255) against both backends, plus the dense-table
emission cost (the extra step the reference doesn't have, paid once per
snapshot).

Host-only (no accelerator needed): run directly with
`python benchmarks/bench_insert.py`.
"""

import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")

import aho_corasick_1975_tpu as ac  # noqa: E402

N_KEYWORDS = 370_099
KEYWORD_LEN = 10     # ~3.7M chars total, matching the baseline's magnitude
BASELINE_CHARS_PER_SEC = 3_864_776 / 0.92


def main():
    rng = np.random.default_rng(0)
    kws = rng.integers(1, 27, (N_KEYWORDS, KEYWORD_LEN)).astype(np.int32)
    # The reference's 370k-keyword baseline registers a *dictionary file*,
    # which is lexicographically sorted — prefix locality dominates insert
    # speed, so report both sorted (baseline-comparable) and random order.
    order = np.lexsort(kws.T[::-1])
    sorted_letters = kws[order].reshape(-1)
    random_letters = kws.reshape(-1)
    offsets = (np.arange(N_KEYWORDS + 1, dtype=np.int64) * KEYWORD_LEN)
    total_chars = int(random_letters.size)

    results = {}

    from aho_corasick_1975_tpu.core.native import NativeBuilder
    for tag, letters in (("sorted", sorted_letters),
                         ("random", random_letters)):
        dt = float("inf")
        for _ in range(3):   # best-of-3: the host VM is shared/noisy
            b = NativeBuilder(True)
            t0 = time.perf_counter()
            ends, fresh = b.insert_keywords_bulk(letters, offsets)
            dt = min(dt, time.perf_counter() - t0)
        results[f"native_bulk_meyer_{tag}"] = {
            "seconds": round(dt, 3),
            "chars_per_sec": round(total_chars / dt),
            "vs_baseline": round(total_chars / dt / BASELINE_CHARS_PER_SEC, 2),
            "keywords": int(fresh.sum()),
            "states": b.n_states,
        }

    t0 = time.perf_counter()
    tables = b.emit_tables()
    results["emit_dense_tables"] = {
        "seconds": round(time.perf_counter() - t0, 3),
        "table_mb": round(tables.delta.nbytes / 1e6, 1),
    }

    # Native AC75 (lazy BFS at emission), sorted order.
    b2 = NativeBuilder(False)
    t0 = time.perf_counter()
    b2.insert_keywords_bulk(sorted_letters, offsets)
    b2.ensure_fail_states()
    dt = time.perf_counter() - t0
    results["native_bulk_ac75_sorted"] = {
        "seconds": round(dt, 3),
        "chars_per_sec": round(total_chars / dt),
        "vs_baseline": round(total_chars / dt / BASELINE_CHARS_PER_SEC, 2),
    }

    # Python backend, smaller sample extrapolated (it is the fallback, not
    # the product path).
    from aho_corasick_1975_tpu.core.builder import Builder
    sample = 20_000
    pb = Builder(True)
    t0 = time.perf_counter()
    for i in range(sample):
        s = 0
        for j in range(i * KEYWORD_LEN, (i + 1) * KEYWORD_LEN):
            s = pb.insert_letter(s, int(random_letters[j]))
        pb.insert_end(s)
    dt = time.perf_counter() - t0
    results["python_backend_sampled"] = {
        "chars_per_sec": round(sample * KEYWORD_LEN / dt),
    }

    print(json.dumps({"metric": "insert_throughput", "results": results}))


if __name__ == "__main__":
    main()
