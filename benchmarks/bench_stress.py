"""Reference Test-3 stress benchmark at full scale (generic_test.c:250-278):
10 increments x 25,000 random 7-char keywords (26-letter alphabet), each
followed by a 1,000,000-char random scan with global match counting.

Reference-local measurements (map shim, SURVEY.md §6): ~0.63-0.74 s per
25k-keyword insert round, ~0.64-0.99 s per 1M-char scan round. Run on a
GPU for device scans: `python benchmarks/bench_stress.py`.
"""

import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")

import aho_corasick_1975_tpu as ac  # noqa: E402

N_INCREMENTS = 10
N_KEYWORDS = 25_000
KEYWORD_LEN = 7
TEXT_LEN = 1_000_000


def main():
    rng = np.random.default_rng(0)
    m = ac.Machine()
    insert_s, scan_s, host_scan_s = [], [], []
    matches = 0
    for _ in range(N_INCREMENTS):
        kw_ids = rng.integers(1, 27, (N_KEYWORDS, KEYWORD_LEN)).astype(np.int32)
        # pre-register letters once so vocab ids == 1..26 (identity here)
        for c in range(26):
            m.vocab.register(chr(ord('a') + c))
        flat = kw_ids.reshape(-1)
        offsets = np.arange(N_KEYWORDS + 1, dtype=np.int64) * KEYWORD_LEN
        t0 = time.perf_counter()
        m._b.insert_keywords_bulk(flat, offsets)
        insert_s.append(time.perf_counter() - t0)

        text_ids = rng.integers(1, 27, TEXT_LEN).astype(np.int32)
        # host native streaming scan (the reference's execution model)
        t0 = time.perf_counter()
        _, host_total = m._b.match_bulk(0, text_ids)
        host_scan_s.append(time.perf_counter() - t0)

        # device scan (count path, snapshot per increment)
        sc = m.scanner(n_streams=1024)
        sc.count(text_ids)  # warm-up/compile
        t0 = time.perf_counter()
        dev_total = sc.count(text_ids)
        scan_s.append(time.perf_counter() - t0)
        assert dev_total == host_total
        matches += dev_total

    print(json.dumps({
        "metric": "test3_stress",
        "insert_seconds_per_25k_round": round(float(np.median(insert_s)), 3),
        "host_scan_seconds_per_1M": round(float(np.median(host_scan_s)), 3),
        "device_scan_seconds_per_1M": round(float(np.median(scan_s)), 3),
        "total_matches": int(matches),
        "n_states": m.n_states,
        "reference_local_insert_s": "0.63-0.74",
        "reference_local_scan_s": "0.64-0.99",
    }))


if __name__ == "__main__":
    main()
