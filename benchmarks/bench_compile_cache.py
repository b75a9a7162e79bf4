"""Cold-process compile cost with and without the persistent XLA cache
(round 5, VERDICT r4 missing #4).

Runs the SAME child workload twice in fresh processes sharing one fresh
cache directory: the first run compiles and populates the cache, the
second should pay roughly cache-read time. Child workload: config-4-class
geometry (tens of thousands of byte keywords, k=1 packed table) plus one
production count at a fixed stream width, timing construction and the
first count (which includes compilation).

Run alone on a GPU (one process per card). Prints one JSON line; writes
results_compile_cache.json.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

CHILD = r"""
import json, sys, time
sys.path.insert(0, %(repo)r)
import numpy as np
t0 = time.perf_counter()
import aho_corasick_1975_tpu as ac
rng = np.random.default_rng(0)
letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
m = ac.ByteMachine()
seen = set()
while len(seen) < 30000:
    w = bytes(rng.choice(letters, rng.integers(4, 12)))
    if w not in seen:
        seen.add(w)
        m.insert_keyword(w)
t_build = time.perf_counter() - t0
sc = m.scanner(n_streams=4096, step_k=1)
corpus = bytes(rng.choice(np.frombuffer(b"abcdefghijklmnopqrstuvwxyz ",
                                        np.uint8), 4 * 1024 * 1024))
t0 = time.perf_counter()
n = sc.count(corpus)
t_first = time.perf_counter() - t0
t0 = time.perf_counter()
assert sc.count(corpus) == n
t_warm = time.perf_counter() - t0
print(json.dumps({"t_build": round(t_build, 2),
                  "t_first_count": round(t_first, 2),
                  "t_warm_count": round(t_warm, 2),
                  "n_states": m.n_states}))
"""


def run_child(env):
    out = subprocess.run([sys.executable, "-c", CHILD % {"repo": REPO}],
                         capture_output=True, text=True, timeout=560,
                         env=env)
    if out.returncode != 0:
        raise RuntimeError(out.stdout + out.stderr)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> None:
    with tempfile.TemporaryDirectory() as d:
        env = dict(os.environ, ACX_COMPILE_CACHE=d)
        cold = run_child(env)
        n_entries = sum(len(fs) for _, _, fs in os.walk(d))
        warm = run_child(env)
        env_off = dict(os.environ, ACX_COMPILE_CACHE="off")
        off = run_child(env_off)
    out = {
        "metric": "cold_process_first_count_seconds",
        "cache_populate_run": cold,
        "cache_hit_run": warm,
        "cache_off_run": off,
        "cache_entries": n_entries,
        "speedup_first_count": round(
            off["t_first_count"] / max(warm["t_first_count"], 1e-9), 2),
    }
    with open(os.path.join(HERE, "results_compile_cache.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
