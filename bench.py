"""Headline benchmark: scan throughput, bytes/sec/chip, on one GPU.

Config follows BASELINE.json's metric shape: English-like text with a
1000-keyword dictionary built from its own most frequent words, scanned on
one chip. The text is the seeded Zipfian corpus of utils/corpus.py (64 MiB;
its seed and shape are printed), and the keywords are byte keywords with
space sentinels.

Measured, each against the host-native oracle's total:
* device-resident: ``count`` on the corpus already on the device as a
  ``jax.Array`` of letter ids;
* end-to-end: ``count`` on the raw bytes (the chunk-pipelined raw path:
  1 byte/symbol upload, the encode inside the scan jit);
* upload only: ``device_put`` of the same raw bytes.

Every timing ends in ``jax.block_until_ready`` (``count`` itself returns a
host int). Refuses to run without a GPU.

vs_baseline compares against the reference's published scan rate (~3.1
MB/s: 376,617 chars in 0.12 s, reference README.md:367).

Prints exactly one JSON line:
  {"metric": ..., "value": N, "unit": "bytes/sec/chip", "vs_baseline": N}
"""

from __future__ import annotations

import json
import sys
import time

BASELINE_BYTES_PER_SEC = 376_617 / 0.12  # reference README.md:367
N_KEYWORDS = 1000
TARGET_BYTES = 64 * 1024 * 1024
N_STREAMS = 16384
REPS = 5


def best_of(fn, reps: int):
    import jax
    best, out = float("inf"), None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best, out


def main() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py: needs a GPU; JAX found {dev.platform}")

    import aho_corasick_1975_tpu as ac
    from aho_corasick_1975_tpu.utils import corpus

    corp = corpus.generate(TARGET_BYTES, n_keywords=N_KEYWORDS)
    text = corp.text
    machine = ac.Machine()
    for w in corp.keywords:
        # byte keywords with word-boundary sentinels — the reference's
        # alphabet is C chars (= bytes, examples/test.c:4), and the raw
        # end-to-end path uploads 1 byte/symbol
        machine.insert_keyword(b" " + w + b" ")
    scanner = machine.scanner(n_streams=N_STREAMS)
    want = machine.match_stream(machine.initiate(), text)

    ids = jnp.asarray(machine.vocab.lookup_many(text))
    total = scanner.count(ids)                     # compile + warm
    dt, total = best_of(lambda: scanner.count(ids), REPS)
    launch = scanner.stats["last_launch"]
    assert total == want, (total, want)

    assert scanner._raw_stream(text) is not None   # really the raw path
    assert scanner.count(text) == want             # compile + warm
    e2e_dt, _ = best_of(lambda: scanner.count(text), 3)

    raw = np.frombuffer(text, np.uint8)
    jax.block_until_ready(jax.device_put(raw))
    up_dt, _ = best_of(lambda: jax.device_put(raw), 2)

    nbytes = len(text)
    value = nbytes / dt
    print(json.dumps({
        "metric": "scan_throughput_zipf_1000kw",
        "value": round(value, 1),
        "unit": "bytes/sec/chip",
        "vs_baseline": round(value / BASELINE_BYTES_PER_SEC, 2),
        "detail": {
            "corpus": {"generator": "utils/corpus.py", "seed": corp.seed,
                       "bytes": nbytes, "word_types": corp.n_types,
                       "zipf_s": corp.zipf_s},
            "n_keywords": machine.nb_keywords(),
            "n_states": machine.n_states,
            "matches": total,
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
            "seconds_per_pass": round(dt, 6),
            "step_k": scanner.step_k,
            "streams": launch["streams"],
            "scan_steps": launch["scan_steps"],
            "engine": ("hybrid" if scanner._hybrid is not None else
                       "mxu" if scanner._mxu is not None else "gather"),
            "end_to_end_bytes_per_sec": round(nbytes / e2e_dt, 1),
            "e2e_input": "raw bytes (uint8 upload, encode on device)",
            "upload_only_bytes_per_sec": round(nbytes / up_dt, 1),
        },
    }))


if __name__ == "__main__":
    main()
