"""Weak-scaling benchmark for the sharded scan: bytes/s per mesh size at
constant work per device, plus the per-scan communication + halo warm-up
share (one (max_kw_len-1)-symbol ppermute halo plus one all_gather of the
per-stream totals, independent of corpus size).

Usage: python benchmarks/bench_scaling.py [--cpu] [n_devices_list...]

It uses the devices that exist; ``--cpu`` runs on 8 virtual CPU devices
instead, which validates the communication structure only (they share the
host's cores, so their efficiency numbers are not hardware scaling).
"""

import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def main():
    import os
    args = sys.argv[1:]
    if "--cpu" in args:
        args.remove("--cpu")
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_force_host_platform_device_count=8")
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax

    import aho_corasick_1975_tpu as ac
    from aho_corasick_1975_tpu.parallel.mesh import make_mesh
    from aho_corasick_1975_tpu.parallel.sharded_scan import ShardedScanner

    sizes = [int(a) for a in args] or [1, 2, 4, 8]
    sizes = [n for n in sizes if n <= jax.local_device_count()]

    rng = np.random.default_rng(0)
    m = ac.Machine()
    kws = rng.integers(1, 27, (2000, 6)).astype(np.int32)
    m._b.insert_keywords_bulk(
        kws.reshape(-1), np.arange(2001, dtype=np.int64) * 6) \
        if hasattr(m._b, "insert_keywords_bulk") else None
    for c in range(26):
        m.vocab.register(chr(ord('a') + c))

    per_dev_chars = 4_000_000  # weak scaling: constant work per device
    results = {}
    base = None
    for n in sizes:
        mesh = make_mesh(n)
        sc = ShardedScanner(m, mesh, n_streams_per_device=256)
        ids = rng.integers(1, 27, per_dev_chars * n).astype(np.int32)
        sc.count(ids)  # warm-up/compile
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            total = sc.count(ids)
            best = min(best, time.perf_counter() - t0)
        rate = len(ids) / best
        results[n] = {"bytes_per_sec": round(rate),
                      "seconds": round(best, 4), "matches": int(total)}
        if base is None:
            base = rate
        results[n]["efficiency_vs_1dev"] = round(rate / (base * n), 3)

    # Communication-overhead isolation: same mesh, same input, same local
    # kernel — once with the real ppermute halo + all_gather, once with
    # halo=0 (no ppermute; the all_gather of B*n int32 totals remains, it
    # is the result itself). The delta IS the per-scan communication +
    # halo-warmup cost, the quantity the >=90% scaling claim rests on
    # (it is constant per scan while compute grows with the corpus).
    from aho_corasick_1975_tpu.parallel.sharded_scan import \
        make_sharded_count
    n = sizes[-1]
    mesh = make_mesh(n)
    sc = ShardedScanner(m, mesh, n_streams_per_device=256, step_k=1)
    ids = rng.integers(1, 27, per_dev_chars * n).astype(np.int32)
    placed, _ = sc._pad_and_place(ids)
    halo_fn = make_sharded_count(mesh, sc.V, sc.halo, 256)
    nohalo_fn = make_sharded_count(mesh, sc.V, 0, 256)

    def run(fn):
        int(np.asarray(fn(sc._dflat, sc._nb_out, placed)).sum(dtype=np.int64))
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            int(np.asarray(fn(sc._dflat, sc._nb_out, placed)).sum(dtype=np.int64))
            best = min(best, time.perf_counter() - t0)
        return best

    t_halo, t_nohalo = run(halo_fn), run(nohalo_fn)
    comm = {
        "n_devices": n, "halo_symbols": sc.halo,
        "seconds_with_halo": round(t_halo, 4),
        "seconds_without": round(t_nohalo, 4),
        "comm_plus_warmup_fraction": round(
            max(t_halo - t_nohalo, 0.0) / t_halo, 4),
    }

    platform = jax.devices()[0].platform
    print(json.dumps({
        "metric": "weak_scaling", "per_device_chars": per_dev_chars,
        "platform": platform,
        "note": ("virtual CPU devices share host cores: efficiency numbers "
                 "are structural validation only, not hardware scaling")
        if platform == "cpu" else "",
        "results": results,
        "comm_overhead": comm}))


if __name__ == "__main__":
    main()
