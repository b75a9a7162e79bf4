"""BASELINE config 5 at spec scale: ~1 GB corpus, 2 OS processes (VERDICT r3 #4).

Round 3 validated the multi-controller path on kilobytes
(tests/test_distributed.py). This benchmark emulates N hosts with N OS
processes on the CPU:

* a 10k-keyword machine (7-char keywords over a 26-letter byte alphabet),
* a ~1 GB uint8 corpus (AC_MP_MB to resize), identical in every process,
* sharded across N processes glued by jax.distributed (1 virtual CPU
  device per process), counts combined by the all_gather/int64 two-level
  reduction (the psum-equivalent global accumulation the reference's
  harness does serially, reference examples/aho_corasick_generic_test.c:271-274),
* +1k Meyer online insertions mid-run, scanner.refresh(), re-count,
  verified against the host-native streaming oracle.

Every worker pins JAX to the CPU before any backend initialization, so no
worker ever opens a GPU and no two processes contend for one card. The
multi-card path on GPUs is one process driving all cards
(``python chip_smoke.py --four``).

Scaling methodology — "N hosts" is emulated by PINNING each process to its
own core (taskset) and the 1-process baseline to one core: per-host compute
is constant, as on a real multi-host cluster, and strong-scaling efficiency
is t1 / (N * tN) for the same global corpus. Without pinning the processes
would time-share the same cores and the number would measure the
scheduler, not the framework.

Run:  python benchmarks/bench_multiprocess.py          # driver, prints one JSON line
      AC_MP_MB=256 python benchmarks/bench_multiprocess.py   # smaller corpus
"""

from __future__ import annotations

import json
import os
import shutil
import socket
import subprocess
import sys
import time

MB = int(os.environ.get("AC_MP_MB", "1024"))
N_KEYWORDS = 10_000
N_ONLINE = 1_000
KW_LEN = 7
REPS = 3
SEED = 7


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# worker


def worker(proc_id: int, nproc: int, port: str) -> None:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=1")
    import jax
    # pinned to the CPU: the worker processes never open a GPU, so no two
    # of them contend for one card
    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import aho_corasick_1975_tpu as ac
    from aho_corasick_1975_tpu.parallel.mesh import (init_distributed,
                                                     make_mesh)
    from aho_corasick_1975_tpu.parallel.sharded_scan import ShardedScanner

    if nproc > 1:
        init_distributed(coordinator_address=f"localhost:{port}",
                         num_processes=nproc, process_id=proc_id)
        assert jax.process_count() == nproc

    rng = np.random.default_rng(SEED)  # identical in every process
    m = ac.Machine(incremental=True)
    for b in range(ord("a"), ord("z") + 1):
        m.vocab.register(b)
    kws = rng.integers(1, 27, (N_KEYWORDS, KW_LEN)).astype(np.int32)
    m._b.insert_keywords_bulk(
        kws.reshape(-1),
        np.arange(N_KEYWORDS + 1, dtype=np.int64) * KW_LEN)

    # ~MB megabytes of byte symbols: the 26 keyword letters + space (OOV).
    n_sym = MB << 20
    alphabet = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz ", np.uint8)
    corpus = alphabet[rng.integers(0, 27, n_sym)]

    mesh = make_mesh()
    sc = ShardedScanner(m, mesh, step_budget_bytes=512 << 20)
    assert sc.step_k >= 2, sc.step_k  # the fast packed path, as single-chip

    # Scan leg: corpus RESIDENT on the mesh (placed once — the serving
    # shape, and the single-chip headline's methodology). Placement is
    # reported separately: device_put onto a multi-process sharding has
    # no zero-copy alias and costs real time per call (measured ~0.5 s /
    # 128 MB), which is why count() now takes pre-placed jax.Arrays.
    import jax.numpy as jnp  # noqa: F401
    from jax.sharding import NamedSharding, PartitionSpec as P
    from aho_corasick_1975_tpu.parallel.mesh import DATA_AXIS
    ids = np.asarray(m.vocab.lookup_many(corpus), np.int32)
    t0 = time.perf_counter()
    placed = jax.device_put(ids, NamedSharding(mesh, P(DATA_AXIS)))
    placed.block_until_ready()
    place_s = time.perf_counter() - t0

    total = sc.count(placed)  # warm-up (compile + first pass)
    t_scan = float("inf")
    for _ in range(REPS):
        t0 = time.perf_counter()
        r = sc.count(placed)
        t_scan = min(t_scan, time.perf_counter() - t0)
    assert r == total
    # end-to-end from host bytes (device-side encode, per-call placement)
    assert sc.count(corpus) == total
    t0 = time.perf_counter()
    sc.count(corpus)
    t_e2e = time.perf_counter() - t0

    # Retrieval legs (round 5, VERDICT r4 #9): the full MatchSet, not
    # just the count — (a) device-resident auto find_matches (the
    # single-pass per-shard-sized path), (b) raw host bytes in.
    ms_dev = sc.find_matches(placed)          # warm-up (compile)
    t_fm_dev = float("inf")
    for _ in range(REPS):
        t0 = time.perf_counter()
        ms_dev = sc.find_matches(placed)
        t_fm_dev = min(t_fm_dev, time.perf_counter() - t0)
    assert len(ms_dev) == total, (len(ms_dev), total)
    t0 = time.perf_counter()
    ms_raw = sc.find_matches(corpus)
    t_fm_raw = time.perf_counter() - t0
    assert len(ms_raw) == total

    # +1k Meyer online insertions (per-edge incremental maintenance), then
    # the in-place snapshot refresh and a re-count on the same corpus.
    more = rng.integers(1, 27, (N_ONLINE, KW_LEN)).astype(np.int32)
    t0 = time.perf_counter()
    m._b.insert_keywords_bulk(
        more.reshape(-1), np.arange(N_ONLINE + 1, dtype=np.int64) * KW_LEN)
    online_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    inplace = sc.refresh()
    refresh_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    total_after = sc.count(placed)  # same ids: no new letters registered
    t_scan_after = time.perf_counter() - t0

    # Host-native streaming oracle (proc 0 only: one pass over the full
    # corpus; the reference's serial accumulation, generic_test.c:271-274).
    oracle = None
    if proc_id == 0:
        ids = m.vocab.lookup_many(corpus)
        _, oracle = m._b.match_bulk(0, ids)
        assert total_after == oracle, (total_after, oracle)

    print("MPBENCH " + json.dumps({
        "proc": proc_id, "nproc": nproc, "corpus_bytes": n_sym,
        "matches": int(total), "matches_after": int(total_after),
        "scan_seconds": round(t_scan, 3),
        "scan_after_seconds": round(t_scan_after, 3),
        "e2e_from_host_bytes_seconds": round(t_e2e, 3),
        "find_matches_device_seconds": round(t_fm_dev, 3),
        "find_matches_raw_seconds": round(t_fm_raw, 3),
        "placement_seconds": round(place_s, 3),
        "online_insert_seconds": round(online_s, 3),
        "refresh_seconds": round(refresh_s, 3),
        "refresh_inplace": bool(inplace),
        "host_oracle_after": None if oracle is None else int(oracle),
        "n_states": m.n_states, "step_k": sc.step_k,
    }), flush=True)


# ---------------------------------------------------------------------------
# driver


def _spawn(nproc: int, port: int):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    have_taskset = shutil.which("taskset") is not None
    procs = []
    for i in range(nproc):
        cmd = [sys.executable, os.path.abspath(__file__), "worker",
               str(i), str(nproc), str(port)]
        if have_taskset:
            cmd = ["taskset", "-c", str(i)] + cmd
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True,
                                      env=env))
    results = []
    for p in procs:
        out, err = p.communicate(timeout=7200)
        if p.returncode != 0:
            raise RuntimeError(f"worker failed (rc={p.returncode}):\n"
                               f"{out}\n{err}")
        line = [ln for ln in out.splitlines() if ln.startswith("MPBENCH ")]
        results.append(json.loads(line[0][len("MPBENCH "):]))
    return results

def main() -> None:
    t0 = time.perf_counter()
    base = _spawn(1, _free_port())[0]       # 1 process, 1 pinned core
    two = _spawn(2, _free_port())           # 2 processes, disjoint cores
    assert {r["matches"] for r in two} == {base["matches"]}
    assert {r["matches_after"] for r in two} == {base["matches_after"]}
    t1, t2 = base["scan_seconds"], max(r["scan_seconds"] for r in two)
    eff = t1 / (2 * t2)
    print(json.dumps({
        "metric": "two_process_scaling_1gb",
        "corpus_bytes": base["corpus_bytes"],
        "keywords": N_KEYWORDS, "online_keywords": N_ONLINE,
        "n_states": base["n_states"], "step_k": base["step_k"],
        "one_process_seconds": t1,
        "one_process_mb_per_sec": round(base["corpus_bytes"] / t1 / 1e6, 1),
        "two_process_seconds": t2,
        "two_process_mb_per_sec_per_proc": round(
            base["corpus_bytes"] / 2 / t2 / 1e6, 1),
        "scaling_efficiency_1_to_2": round(eff, 3),
        "matches": base["matches"], "matches_after": base["matches_after"],
        "host_oracle_agrees": base["matches_after"] == base[
            "host_oracle_after"],
        "one_process_e2e_seconds": base["e2e_from_host_bytes_seconds"],
        "two_process_e2e_seconds": max(
            r["e2e_from_host_bytes_seconds"] for r in two),
        "one_process_find_matches_device_seconds": base[
            "find_matches_device_seconds"],
        "two_process_find_matches_device_seconds": max(
            r["find_matches_device_seconds"] for r in two),
        "retrieval_scaling_efficiency_1_to_2": round(
            base["find_matches_device_seconds"]
            / (2 * max(r["find_matches_device_seconds"] for r in two)), 3),
        "one_process_find_matches_raw_seconds": base[
            "find_matches_raw_seconds"],
        "two_process_find_matches_raw_seconds": max(
            r["find_matches_raw_seconds"] for r in two),
        "placement_seconds": two[0]["placement_seconds"],
        "online_insert_seconds": two[0]["online_insert_seconds"],
        "refresh_seconds": two[0]["refresh_seconds"],
        "refresh_inplace": two[0]["refresh_inplace"],
        "pinning": "taskset 1 core per process (per-host compute constant)",
        "wall_seconds": round(time.perf_counter() - t0, 1),
    }))


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "worker":
        worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    else:
        main()
