#!/usr/bin/env python3
"""Smoke run of the scanner on NVIDIA GPUs, checked exactly against the
host-native oracle.

    python chip_smoke.py          # one GPU: phases 1-6 below
    python chip_smoke.py --four   # four GPUs: the mesh path only

It drives the library through its public entry points (``Machine``,
``machine.scanner()``, ``DenseScanner``, ``ShardedScanner``,
``StreamSession``) at deployment size, and compares every count, hit list
and session total with the host oracle (``Machine.match_stream`` /
``match_stream_many`` / the cursor API), which runs the C++ core in
native/acx.cpp and shares no code with the device kernels. Results are
integers and must agree exactly.

Phases (one GPU):
  1. device: a GPU or exit non-zero; card name and power limit, JAX
     version, compile-cache directory, native core build;
  2. golden conformance: the he/she/his/hers flow;
  3. headline deployment: the 1,000 most frequent words of a seeded
     Zipfian corpus (utils/corpus.py) over 64 MiB of it — count (raw
     pipelined and device-resident), find_matches, count_many, a session
     fed unaligned chunks with an insert + refresh() while it is open,
     and two same-length inputs back to back;
  4. config-3 scale: 10,000 random 8-letter keywords (~80k states), a
     512 MiB step budget, 100 MB corpus, peak device memory;
  5. every engine (gather, mxu, hybrid), the prefilter and calibration at
     a small automaton and at the headline automaton;
  6. timings (block_until_ready / a host read of the result): seconds per
     device-resident pass per engine, lax.scan steps and us per step,
     end-to-end count(bytes) rate, first-call compile seconds.

Any failed check raises, so the script exits non-zero and prints no result
line. The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HEADLINE_BYTES = 64 << 20
CONFIG3_BYTES = 100_000_000
PAIRS_PREFIX = 1 << 20
CARD = "unknown card"


def log(msg: str) -> None:
    print(msg, flush=True)


def check(name: str, got, want) -> None:
    if isinstance(got, np.ndarray) or isinstance(want, np.ndarray):
        same = np.array_equal(np.asarray(got), np.asarray(want))
    else:
        same = got == want
    if not same:
        raise AssertionError(f"{name}: device {got!r} != oracle {want!r}")
    shown = (f"{len(got)} values" if isinstance(got, np.ndarray)
             else repr(got))
    log(f"  ok {name}: {shown}")


def timing(msg: str) -> None:
    log(f"  time [{CARD}] {msg}")


def best_of(fn, reps: int = 3):
    """(best seconds, last result) over ``reps`` timed calls; the result
    is blocked on (block_until_ready) or is already a host value."""
    import jax
    best, out = float("inf"), None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best, out


# -- oracle (host-native C++ core, no device code) ---------------------------

def oracle_count(machine, data) -> int:
    return int(machine.match_stream(machine.initiate(), data))


def oracle_pairs(machine, data: bytes):
    """(end, keyword rank) of every occurrence, through the cursor API
    (acm_match / acm_get_match), longest first within a position."""
    cur = machine.initiate()
    ends, ranks = [], []
    for i, sign in enumerate(data):
        for j in range(machine.match(cur, sign)):
            ends.append(i)
            ranks.append(machine.get_match(cur, j).rank)
    return np.asarray(ends, np.int64), np.asarray(ranks, np.int64)


def check_pairs(name: str, matchset, machine, data: bytes) -> None:
    ends, ranks = oracle_pairs(machine, data)
    check(f"{name} ends", matchset.ends, ends)
    check(f"{name} keywords", matchset.ranks.astype(np.int64), ranks)


# -- phase 1 ----------------------------------------------------------------

def phase_device(n_cards: int):
    import jax
    global CARD
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: needs a GPU; JAX found {devs[0].platform}")
    if len(devs) < n_cards:
        sys.exit(f"chip_smoke: needs {n_cards} GPUs; JAX found {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    CARD = smi.splitlines()[0].strip()
    log("phase 1: device")
    log(f"  device_kind {devs[0].device_kind}, {len(devs)} device(s), "
        f"jax {jax.__version__}")
    for line in smi.splitlines():
        log(f"  nvidia-smi: {line.strip()}")
    from aho_corasick_1975_tpu.core import native
    fresh = (not os.path.exists(native._SO)
             or os.path.getmtime(native._SO) < os.path.getmtime(native._SRC))
    native.load_library()
    log(f"  native core: {native._SO} "
        f"{'built now from' if fresh else 'up to date with'} acx.cpp")
    import aho_corasick_1975_tpu as ac
    if type(ac.Machine()._b).__name__ != "NativeBuilder":
        raise AssertionError("the oracle is not the native C++ core")
    from aho_corasick_1975_tpu.utils.compile_cache import enable_compile_cache
    log(f"  compile cache: {enable_compile_cache()} "
        f"(JAX_COMPILATION_CACHE_DIR="
        f"{os.environ.get('JAX_COMPILATION_CACHE_DIR')})")
    return devs


# -- phase 2 ----------------------------------------------------------------

def phase_golden() -> None:
    import aho_corasick_1975_tpu as ac
    log("phase 2: golden conformance")
    m = ac.Machine()
    for kw in ["he", "she", "his", "hers"]:
        m.insert_keyword(kw)
    text = "To ushers: he found his pencil, but she could not find hers."
    cur, line = m.initiate(), []
    for i, ch in enumerate(text):
        for j in range(m.match(cur, ch), 0, -1):
            mt = m.get_match(cur, j - 1)
            line.append(f" {i + 2 - mt.length}:{mt.text()}")
    check("cursor flow", "".join(line),
          " 6:he 5:she 6:hers 12:he 21:his 38:he 37:she 56:he 56:hers")
    sc = m.scanner()
    check("scanner().count", sc.count(text), 9)
    check_pairs("find_matches", sc.find_matches(text), m, text)


# -- phase 3 ----------------------------------------------------------------

def headline_machine(keywords):
    import aho_corasick_1975_tpu as ac
    m = ac.Machine()
    for w in keywords:
        # byte keywords with word-boundary sentinels (bench.py's shape)
        m.insert_keyword(b" " + w + b" ")
    return m


def mixed_docs(text: bytes, n: int, seed: int):
    """``n`` slices of ``text`` with log-uniform lengths 1 B .. 256 KiB."""
    rng = np.random.default_rng(seed)
    lens = np.exp(rng.uniform(0, np.log(256 << 10), n)).astype(np.int64)
    starts = rng.integers(0, len(text) - int(lens.max()), n)
    return [text[s:s + ln] for s, ln in zip(starts.tolist(), lens.tolist())]


def phase_headline(corp) -> None:
    import jax.numpy as jnp
    log("phase 3: headline deployment")
    text = corp.text
    m = headline_machine(corp.keywords[:1000])
    new_word = corp.keywords[1000]          # held out for the refresh
    log(f"  corpus: seed {corp.seed}, {len(text)} bytes, {corp.n_types} "
        f"word types, Zipf s={corp.zipf_s}; dictionary: "
        f"{m.nb_keywords()} keywords, {m.n_states} states, "
        f"V={m.vocab.size}")
    want = oracle_count(m, text)
    sc = m.scanner()
    log(f"  scanner: step_k {sc.step_k}, halo {sc.halo}")
    t0 = time.perf_counter()
    got = sc.count(text)
    timing(f"first count(bytes) call (compile + run): "
           f"{time.perf_counter() - t0:.3f} s")
    if len(text) < sc._pipeline_min:
        raise AssertionError("headline corpus below the pipelined path")
    check("count(bytes), chunk-pipelined raw path", got, want)
    ids = jnp.asarray(m.vocab.lookup_many(text))
    t0 = time.perf_counter()
    got = sc.count(ids)
    timing(f"first device-resident count call (compile + run): "
           f"{time.perf_counter() - t0:.3f} s")
    check("count(device-resident jax.Array)", got, want)
    fm = sc.find_matches(text)
    check("find_matches over the whole corpus, event count", len(fm), want)
    prefix = text[:PAIRS_PREFIX]
    check_pairs(f"find_matches on a {len(prefix)}-byte prefix",
                sc.find_matches(prefix), m, prefix)
    docs = mixed_docs(text, 256, corp.seed)
    check("count_many over 256 mixed-length documents",
          sc.count_many(docs), m.match_stream_many(docs))
    # same-length inputs back to back: the reused staging buffer
    half = len(text) // 2
    a, b = text[:1 << 20], text[half:half + (1 << 20)]
    check("back-to-back count A", sc.count(a), oracle_count(m, a))
    check("back-to-back count B", sc.count(b), oracle_count(m, b))
    check("back-to-back count A again", sc.count(a), oracle_count(m, a))

    # a session fed unaligned chunks; insert + refresh() while it is open
    P = Q = min(8 << 20, len(text) // 4)
    rng = np.random.default_rng(corp.seed + 1)
    sess = sc.session()

    def feed(lo, hi):
        pos = lo
        while pos < hi:
            step = int(rng.integers(1, 3 << 20))
            sess.feed_count(text[pos:min(hi, pos + step)])
            pos = min(hi, pos + step)

    feed(0, P)
    old_prefix = oracle_count(m, text[:P])
    check("session total before refresh", sess.total, old_prefix)
    if len(new_word) + 2 > m.compile().max_depth:
        raise AssertionError("held-out keyword longer than the halo")
    m.insert_keyword(b" " + new_word + b" ")
    in_place = sc.refresh()
    log(f"  refresh(): in place {in_place}, "
        f"{sc.stats.get('refresh_cells')} stepped cells")
    feed(P, P + Q)
    want_sess = (old_prefix + oracle_count(m, text[:P + Q])
                 - oracle_count(m, text[:P]))
    check("session total across refresh", sess.total, want_sess)
    check("count after refresh (donated tables)", sc.count(text),
          oracle_count(m, text))


# -- phase 4 ----------------------------------------------------------------

def phase_config3(seed: int, dev) -> None:
    import aho_corasick_1975_tpu as ac
    log("phase 4: config-3 scale")
    rng = np.random.default_rng([seed, 3])
    kws = rng.integers(ord("a"), ord("z") + 1, (10_000, 8), dtype=np.uint8)
    m = ac.Machine()
    m.insert_keywords([bytes(r) for r in kws])
    text = rng.integers(ord("a"), ord("z") + 1, CONFIG3_BYTES,
                        dtype=np.uint8)
    # random text alone holds a handful of matches: plant keywords at
    # CONFIG3_BYTES / 100 random positions so the count means something
    at = rng.integers(0, CONFIG3_BYTES - 8, CONFIG3_BYTES // 100)
    text[at[:, None] + np.arange(8)] = kws[rng.integers(0, 10_000, len(at))]
    sc = m.scanner(step_budget_bytes=512 << 20)
    table_mb = sc._st_dev[0].nbytes / 2 ** 20 if sc._st_dev else 0.0
    log(f"  {m.nb_keywords()} keywords, {m.n_states} states, "
        f"V={m.vocab.size}, step_k {sc.step_k}, packed stepped table "
        f"{table_mb:.1f} MiB on device; corpus {len(text)} bytes")
    check("count over the 100 MB corpus", sc.count(text),
          oracle_count(m, text))
    stats = dev.memory_stats() or {}
    log(f"  peak_bytes_in_use {stats.get('peak_bytes_in_use')}")


# -- phases 5 and 6 -----------------------------------------------------------

def sparse_text(corp, n: int, seed: int) -> bytes:
    """Digits (no keyword letter) with a headline keyword planted every
    ~64 KiB: a low-density corpus for the prefilter."""
    rng = np.random.default_rng(seed)
    buf = bytearray(rng.integers(ord("0"), ord("9") + 1, n,
                                 dtype=np.uint8).tobytes())
    for pos in range(1000, n - 64, 65536):
        w = b" " + corp.keywords[int(rng.integers(0, 1000))] + b" "
        buf[pos:pos + len(w)] = w
    return bytes(buf)


def engine_pass(name: str, sc, m, text: bytes, ids, docs) -> float:
    """Check one scanner's count paths; return its best device-resident
    seconds per pass over ``ids``."""
    want = oracle_count(m, text)
    check(f"{name} count(bytes)", sc.count(text), want)
    check(f"{name} count(device)", sc.count(ids), want)
    check(f"{name} count_many", sc.count_many(docs),
          m.match_stream_many(docs))
    dt, got = best_of(lambda: sc.count(ids), reps=5)
    check(f"{name} count(device) timed", got, want)
    return dt


def phase_engines(corp) -> dict:
    import jax.numpy as jnp
    log("phase 5: every engine, the prefilter, calibration")
    text = corp.text
    docs = mixed_docs(text[:8 << 20], 32, corp.seed + 2)
    small = headline_machine(corp.keywords[:60])
    head = headline_machine(corp.keywords[:1000])
    ids = jnp.asarray(head.vocab.lookup_many(text))
    times = {}
    for label, m in (("small", small), ("headline", head)):
        from aho_corasick_1975_tpu.ops.scan_mxu import padded_states
        log(f"  {label} automaton: {m.n_states} states, "
            f"{padded_states(m.n_states)} padded")
        m_ids = ids if m is head else jnp.asarray(m.vocab.lookup_many(text))
        for engine in ("gather", "mxu", "hybrid"):
            try:
                sc = m.scanner(engine=engine)
            except ValueError as e:
                if not (engine == "mxu" and padded_states(m.n_states) > 512):
                    raise
                log(f"  {label} mxu: refused as designed ({e})")
                continue
            dt = engine_pass(f"{label} {engine}", sc, m, text, m_ids, docs)
            times[(label, engine)] = (dt, sc.stats["last_launch"])
        sc = m.scanner(prefilter="on")
        check(f"{label} prefilter=on count(bytes), host filter",
              sc.count(text), oracle_count(m, text))
        check(f"{label} prefilter=on count(device), device filter",
              sc.count(m_ids), oracle_count(m, text))
        sparse = sparse_text(corp, 16 << 20, corp.seed + 3)
        check(f"{label} prefilter=on count(sparse bytes)", sc.count(sparse),
              oracle_count(m, sparse))
        check_pairs(f"{label} prefilter=on find_matches(sparse prefix)",
                    sc.find_matches(sparse[:PAIRS_PREFIX]), m,
                    sparse[:PAIRS_PREFIX])
        check_pairs(f"{label} prefilter=on find_matches(prefix)",
                    sc.find_matches(text[:PAIRS_PREFIX]), m,
                    text[:PAIRS_PREFIX])
        sc = m.scanner(calibrate=True)
        cal = sc.stats.get("calibration")
        chosen = min(cal, key=cal.get) if cal else "gather"
        log(f"  {label} calibrate=True: probe seconds {cal}, chose {chosen}")
        check(f"{label} calibrated count(bytes)", sc.count(text),
              oracle_count(m, text))
    return times


def phase_timings(corp, times: dict) -> None:
    log("phase 6: timings")
    n = len(corp.text)
    for (label, engine), (dt, launch) in sorted(times.items()):
        steps = launch["scan_steps"]
        timing(f"{label} {engine}: device-resident {dt:.6f} s per pass "
               f"({n / dt / 1e6:.1f} MB/s), {launch['streams']} streams x "
               f"{steps} lax.scan steps, {dt / steps * 1e6:.3f} us per step")
    m = headline_machine(corp.keywords[:1000])
    sc = m.scanner()
    sc.count(corp.text)
    dt, got = best_of(lambda: sc.count(corp.text))
    check("end-to-end count(bytes) timed", got, oracle_count(m, corp.text))
    timing(f"headline end-to-end count(bytes): {dt:.6f} s "
           f"({n / dt / 1e6:.1f} MB/s)")


# -- --four: the mesh path -----------------------------------------------------

def phase_mesh(corp) -> None:
    import jax
    import jax.numpy as jnp  # noqa: F401
    from aho_corasick_1975_tpu.parallel.mesh import data_sharded, make_mesh
    from aho_corasick_1975_tpu.parallel.sharded_scan import ShardedScanner
    log("mesh: ShardedScanner on make_mesh(4)")
    text = corp.text
    m = headline_machine(corp.keywords[:1000])
    new_word = corp.keywords[1000]
    mesh = make_mesh(4)
    ss = ShardedScanner(m, mesh)
    ds = m.scanner()
    want = oracle_count(m, text)
    check("mesh count(bytes)", ss.count(text), want)
    check("one-card count(bytes)", ds.count(text), want)
    fm, fd = ss.find_matches(text), ds.find_matches(text)
    check("mesh find_matches event count", len(fm), want)
    check("mesh find_matches ends == one card", fm.ends, fd.ends)
    check("mesh find_matches keywords == one card", fm.end_states,
          fd.end_states)
    prefix = text[:PAIRS_PREFIX]
    check_pairs("mesh find_matches prefix", ss.find_matches(prefix), m,
                prefix)
    docs = mixed_docs(text, 256, corp.seed)
    want_docs = m.match_stream_many(docs)
    check("mesh count_many", ss.count_many(docs), want_docs)
    check("one-card count_many", ds.count_many(docs), want_docs)
    ids = np.asarray(m.vocab.lookup_many(text))
    cards = jax.devices()[:4]

    def in_use():
        return [(d.memory_stats() or {}).get("bytes_in_use", 0) or 0
                for d in cards]

    before = in_use()
    placed = jax.device_put(ids, data_sharded(mesh))
    jax.block_until_ready(placed)
    after = in_use()
    log(f"  placed a {ids.nbytes}-byte id corpus with "
        f"NamedSharding(mesh, P('data'))")
    for d, b0, b1 in zip(cards, before, after):
        log(f"  {d}: bytes_in_use {b1} (+{b1 - b0} for the corpus)")
    check("mesh count(NamedSharding corpus)", ss.count(placed), want)
    rng = np.random.default_rng(corp.seed + 1)
    sess = ss.session()
    P = min(8 << 20, len(text) // 4)
    pos = 0
    while pos < P:
        step = int(rng.integers(1, 3 << 20))
        sess.feed_count(text[pos:min(P, pos + step)])
        pos = min(P, pos + step)
    old_prefix = oracle_count(m, text[:P])
    check("mesh session total", sess.total, old_prefix)
    m.insert_keyword(b" " + new_word + b" ")
    log(f"  mesh refresh(): in place {ss.refresh()}")
    while pos < 2 * P:
        step = int(rng.integers(1, 3 << 20))
        sess.feed_count(text[pos:min(2 * P, pos + step)])
        pos = min(2 * P, pos + step)
    check("mesh session total across refresh", sess.total,
          old_prefix + oracle_count(m, text[:2 * P])
          - oracle_count(m, text[:P]))
    want = oracle_count(m, text)
    ds.refresh()
    check("mesh count after refresh", ss.count(text), want)
    check("one-card count after refresh", ds.count(text), want)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU mesh path")
    args = ap.parse_args(argv)
    n_cards = 4 if args.four else 1
    devs = phase_device(n_cards)
    from aho_corasick_1975_tpu.utils import corpus
    t0 = time.perf_counter()
    corp = corpus.generate(HEADLINE_BYTES, n_keywords=1001)
    log(f"  corpus generated in {time.perf_counter() - t0:.1f} s")
    if args.four:
        phase_mesh(corp)
    else:
        phase_golden()
        phase_headline(corp)
        phase_config3(corp.seed, devs[0])
        times = phase_engines(corp)
        phase_timings(corp, times)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
