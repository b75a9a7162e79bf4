"""Filter-then-verify sparse scan benchmark (ops/sparse.py).

Scenario the reference cannot express at speed: hunting rare patterns
(signatures, needles) through a corpus where most symbols belong to no
keyword. The dense kernel pays the gather rate on EVERY symbol
(reference aho_corasick.c:433-448 walks every one too); the sparse
path pays one host bandwidth pass over the encoded ids plus the gather
rate only on live blocks.

Methodology (same device-resident contract as bench.py — a per-call 256 MB
corpus upload would swamp every kernel): the staged corpus ext is uploaded ONCE; every timed sparse
repetition then includes (a) the host live-block filter pass over the
ids, (b) building + uploading the live-block index list, (c) the device
window-gather + count kernel, synchronously materialized. The dense
comparison times the same-contract stream kernel on the same resident
ext. Prints one JSON line per density.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import aho_corasick_1975_tpu as ac  # noqa: E402
from aho_corasick_1975_tpu.ops import multistep as ms  # noqa: E402
from aho_corasick_1975_tpu.ops import sparse  # noqa: E402
from aho_corasick_1975_tpu.ops.scan_xla import \
    make_blocked_count_stream  # noqa: E402

KEYWORDS = ["needle", "haystack", "signature", "marker", "beacon",
            "sentinel", "flagged", "tracer"]
N = 64 * 1024 * 1024  # 64 Mi symbols


def build_corpus(density: float, n_live_ids: int) -> np.ndarray:
    """Pre-encoded ids: OOV (0) everywhere except uniformly sprinkled
    8-symbol live runs — uniform sprinkling is the filter's WORST case
    (clumpy real corpora give lower live fractions at equal density)."""
    rng = np.random.default_rng(7)
    ids = np.zeros(N, np.int32)
    n_runs = int(N * density / 8)
    starts = rng.integers(0, N - 16, n_runs)
    pos = (starts[:, None] + np.arange(8)[None, :]).reshape(-1)
    ids[pos] = rng.integers(1, n_live_ids + 1, pos.shape[0]).astype(np.int32)
    return ids


def timed(fn, reps=3):
    fn()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    import jax.numpy as jnp

    m = ac.Machine()
    for kw in KEYWORDS:
        m.insert_keyword(kw)
    n_live_ids = len(set("".join(KEYWORDS)))
    sc = m.scanner(n_streams=4096, engine="gather")
    st = sc._stepped
    use_stepped = st is not None and st.packed is not None
    k = st.k if use_stepped else 1
    halo = sc._halo_sym if use_stepped else sc.halo
    L_blk = 128 * k

    for density in (1.0, 0.01, 0.001, 0.0001):
        if density == 1.0:
            rng = np.random.default_rng(3)
            ids = rng.integers(1, n_live_ids + 1, N).astype(np.int32)
        else:
            ids = build_corpus(density, n_live_ids)

        # --- resident corpus for the sparse kernel ---
        nB_real = -(-N // L_blk)
        nB = 1 << (nB_real - 1).bit_length()
        ext = np.zeros(halo + (nB + 1) * L_blk, np.int32)
        ext[halo:halo + N] = ids
        ext_dev = jnp.asarray(ext)

        def sparse_pass():
            live = sparse.live_blocks(ids, L_blk)       # host filter pass
            n_live = int(live.sum())
            if n_live == 0:
                return 0
            cap = max(8, 1 << (n_live - 1).bit_length())
            idx = np.full(cap, nB, np.int32)
            idx[:n_live] = np.flatnonzero(live)
            if use_stepped:
                fn = sparse.make_sparse_count_stepped(
                    st.V, st.k, st.Vk, st.count_bits, sc._halo_steps,
                    L_blk, nB, cap)
                per = fn(sc._st_dev[0], ext_dev, jnp.asarray(idx))
            else:
                fn = sparse.make_sparse_count(sc.V, halo, L_blk, nB, cap)
                per = fn(sc._dflat, sc._nb_out, ext_dev, jnp.asarray(idx))
            return int(np.asarray(per).sum(dtype=np.int64))

        # --- resident corpus for the dense stream kernel (bench.py shape) ---
        ext2, B, L, _ = sc._stream_ext(ids, None, halo, 128 * k)
        if use_stepped:
            dense_fn = ms.make_stepped_count_stream(
                st.V, st.k, st.Vk, st.count_bits, sc._halo_steps, B, L)
            tabs = sc._st_dev
        else:
            dense_fn = make_blocked_count_stream(sc.V, halo, B, L)
            tabs = (sc._dflat, sc._nb_out)

        def dense_pass():
            return int(np.asarray(dense_fn(*tabs, ext2)).sum(dtype=np.int64))

        want, got = dense_pass(), sparse_pass()
        assert got == want, (got, want)
        live_frac = float(sparse.live_blocks(ids, L_blk).mean())
        t_sp, t_dense = timed(sparse_pass), timed(dense_pass)
        print(json.dumps({
            "metric": "sparse_scan_effective_throughput",
            "density": density, "live_frac": round(live_frac, 5),
            "value": round(N / t_sp, 1), "unit": "bytes/sec/chip",
            "seconds": round(t_sp, 4),
            "dense_kernel_bytes_per_sec": round(N / t_dense, 1),
            "speedup_vs_dense": round(t_dense / t_sp, 2),
            "step_k": k, "matches": int(want)}), flush=True)


if __name__ == "__main__":
    main()
