#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (stringsearchlib_tpu_torch).

Drives the port's main path once on one CUDA card: the headline batch
search of ``bench.py`` (product-name corpus, uniform weights, 512-query
batches at threshold 0.3, top-100) through ``SearchEngine.search_batch``,
which routes it to the hand-written K1 kernel and the integer h* finish.

Phases, each printing one line with its seconds; any failure raises, so the
script exits non-zero and prints no final ``ok`` line:

  1. device: a CUDA card is required; prints nvidia-smi's name and power
     limit;
  2. build: compiles K1 from csrc/ with nvcc and the native index builder
     with g++, and says whether the native builder loaded;
  3. K1 against its plain PyTorch version on random tables (every bit set
     somewhere, bit 7 included; multiplicities summing to 31 and to 127):
     bit-identical hits and block maxima;
  4. main path: builds the index on the card, runs one warm-up and three
     timed batches of 512 queries, requires the bitmap_kernel + h* route and
     K1 launches; then times 64 single queries;
  5. K1 on the real table: on the whole resident table with real queries'
     counts at B = 256 and at the engine's step, bit-identical to the plain
     version; both timed with CUDA events;
  6. exactness: 32 queries again through the dense path, requiring the
     same (score, key length) tie groups holding the same keys.

The line before the last is a JSON object describing the kernels; the last
line is ``{"ok": true, "device": {...}}``.

Usage:  python3 chip_smoke.py [--keys N]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import random
import subprocess
import sys
import time

os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")

_ROOT = os.path.dirname(os.path.abspath(__file__))
_T0 = time.perf_counter()
N_QUERIES = 512  # one batch of the headline (bench.py)
REPS = 3
N_SINGLE = 64


def _phase(name: str, t0: float, **info) -> None:
    extra = " ".join(f"{k}={v}" for k, v in info.items())
    print(
        f"[phase {name}] {time.perf_counter() - t0:.2f}s "
        f"(total {time.perf_counter() - _T0:.1f}s) {extra}",
        flush=True,
    )


def _cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, after one warm-up,
    timed with CUDA events."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _random_case(gen, b: int, gp: int, ntiles: int, total: int, device):
    """Random tile-major table (uniform bytes: every bit, bit 7 included,
    is set somewhere) and (b, gp) multiplicities summing to ``total``
    per row over distinct columns."""
    import torch

    planes = torch.randint(
        -128, 128, (ntiles, gp, 512), generator=gen, dtype=torch.int8
    )
    qcnt = torch.zeros((b, gp), dtype=torch.int32)
    for r in range(b):
        ncol = min(gp, total, 1 + int(torch.randint(0, 40, (1,), generator=gen)))
        cols = torch.randperm(gp, generator=gen)[:ncol]
        # split `total` into ncol positive parts
        cuts = torch.sort(torch.randperm(total - 1, generator=gen)[: ncol - 1] + 1).values
        parts = torch.diff(
            torch.cat([torch.tensor([0]), cuts, torch.tensor([total])])
        )
        qcnt[r, cols] = parts.to(torch.int32)
    assert int(qcnt.sum(1).min()) == total and int(qcnt.sum(1).max()) == total
    return planes.to(device), qcnt.to(device)


def _trace(run) -> dict:
    """One traced call of ``run`` under torch.profiler: device time by
    kernel name (top 8), K1's share, and the device's busy and idle share
    of the call's wall time (kernel intervals merged)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = [
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events()
        if str(e.device_type).endswith("CUDA")
    ]
    if not spans:
        return {"device_time": "not measured (no device events in the trace)"}
    by_name: dict = {}
    for a, b, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    busy, end = 0.0, float("-inf")
    for a, b, _ in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    k1 = sum(v for k, v in by_name.items() if "bitmap_hits_bmax" in k)
    return {
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy / 1e3,
        "device_idle_share": max(0.0, 1.0 - busy / wall_us),
        "k1_ms": k1 / 1e3,
        "top_kernels_ms": {k[:80]: v / 1e3 for k, v in top},
        "n_kernel_launches": len(spans),
    }


def _max_abs_err(a, b, rows: int = 32) -> int:
    """Largest |a - b| over two equal-shape int8 tensors, taken ``rows``
    rows at a time so the widened copies stay small."""
    import torch

    err = 0
    for r in range(0, a.shape[0], rows):
        d = a[r : r + rows].to(torch.int16) - b[r : r + rows].to(torch.int16)
        err = max(err, int(d.abs().max()))
    return err


def _tie_groups(keys, scores):
    groups: dict = {}
    for k, s in zip(keys, scores):
        groups.setdefault((float(s), len(k)), set()).add(k)
    return groups


def np_tile(slots, b: int):
    """``b`` rows of real query slots, cycling through the ones given."""
    import numpy as np

    reps = -(-b // slots.shape[0])
    return np.ascontiguousarray(np.tile(slots, (reps, 1))[:b])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--keys", type=int, default=10_000_000)
    args = ap.parse_args()

    # -- 1. device ----------------------------------------------------------
    t0 = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _phase("device", t0, kind=repr(kind), count=count, torch=torch.__version__,
           cuda=torch.version.cuda)

    # -- 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    sys.path.insert(0, _ROOT)
    import bench
    from stringsearchlib_tpu_torch.config import IndexConfig
    from stringsearchlib_tpu_torch.index import build as buildmod
    from stringsearchlib_tpu_torch.index import native as nativelib
    from stringsearchlib_tpu_torch.ops import bitmap_matmul as bmm
    from stringsearchlib_tpu_torch.search.candidates import query_counts
    from stringsearchlib_tpu_torch.search.engine import SearchEngine

    so = bmm.build_kernel()
    bmm._lib()
    native = nativelib.get_native() is not None
    _phase("build", t0, kernel_so=os.path.relpath(so, _ROOT), native_builder=native)

    # -- 3. K1 vs plain, random tables -------------------------------------
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(1234)
    max_err = 0
    n_cases = 0
    for gp in (128, 2816, 6144):
        for b in (16, 256, 512):
            for total in (31, 127):
                planes, qcnt = _random_case(gen, b, gp, 3, total, dev)
                hits, bmax = bmm.bitmap_hits_bmax(qcnt, planes)
                rh, rb = bmm.bitmap_hits_bmax_ref(qcnt, planes)
                torch.cuda.synchronize()
                err = max(
                    int((hits.int() - rh.int()).abs().max()),
                    int((bmax.int() - rb.int()).abs().max()),
                )
                max_err = max(max_err, err)
                n_cases += 1
                if err or not torch.equal(hits, rh) or not torch.equal(bmax, rb):
                    raise AssertionError(
                        f"K1 differs from its plain version: gp={gp} b={b} "
                        f"sum={total} max_abs_err={err}"
                    )
    _phase("k1_random", t0, cases=n_cases, max_abs_err=max_err)

    # -- 4. main path -----------------------------------------------------------
    t0 = time.perf_counter()
    words = bench._product_names(args.keys, seed=2)
    t_corpus = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    host = buildmod.build_index(words, 1, None, IndexConfig(), device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t1
    breakdown = dict(buildmod.LAST_BUILD_BREAKDOWN)
    t1 = time.perf_counter()
    engine = SearchEngine(host)
    bm = host.bitmap_tables(engine.BITMAP_BUDGET)
    torch.cuda.synchronize()
    table_s = time.perf_counter() - t1
    if bm is None:
        raise AssertionError("packed table over BITMAP_BUDGET")
    table = bm[0]
    print(json.dumps({
        "build_breakdown": breakdown, "builder": "native" if "native_cpp" in breakdown else "numpy",
        "corpus_s": round(t_corpus, 2), "build_s": round(build_s, 2),
        "bitmap_table_s": round(table_s, 2), "n_keys": len(words),
        "n_terms": host.n_terms, "n_grams": host.n_grams,
        "bitmap_bytes": int(table.numel()), "table_shape": list(table.shape),
        "peak_mem_build_bytes": int(torch.cuda.max_memory_allocated()),
    }), flush=True)
    if "native_cpp" not in breakdown:
        raise AssertionError("the native builder did not run")

    rng = random.Random(7)
    queries = [bench._mutate(rng, rng.choice(words)) for _ in range(N_QUERIES)]
    threshold, limit = 0.3, 100
    torch.cuda.reset_peak_memory_stats()
    bmm.KERNEL_LAUNCHES = 0
    bmm.REF_CALLS = 0
    t1 = time.perf_counter()
    results = engine.search_batch(queries, threshold, limit, batch_bucket=512)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t1
    rep_s = []
    for _ in range(REPS):
        t1 = time.perf_counter()
        results = engine.search_batch(queries, threshold, limit, batch_bucket=512)
        torch.cuda.synchronize()
        rep_s.append(time.perf_counter() - t1)
    launches = bmm.KERNEL_LAUNCHES
    ref_calls = bmm.REF_CALLS
    routing = dict(engine.last_routing)
    peak_search = int(torch.cuda.max_memory_allocated())
    if routing.get("variant") != "bitmap_kernel" or not routing.get("hstar"):
        raise AssertionError(f"main path did not take bitmap_kernel + h*: {routing}")
    if launches <= 0 or ref_calls:
        raise AssertionError(f"K1 launches={launches} plain calls={ref_calls}")
    if len(results) != len(queries) or any(r is None for r in results):
        raise AssertionError("missing results")
    for keys, scores in results:
        if len(keys) != len(scores) or len(keys) > limit:
            raise AssertionError("malformed result row")
        if any(not (math.isfinite(s) and s >= threshold) for s in scores):
            raise AssertionError("non-finite score or score below the threshold")
    med = sorted(rep_s)[len(rep_s) // 2]
    engine.search(queries[0], threshold, limit)
    single_ms = []
    for q in queries[:N_SINGLE]:
        t1 = time.perf_counter()
        engine.search(q, threshold, limit)
        single_ms.append((time.perf_counter() - t1) * 1e3)
    single_ms.sort()
    trace = _trace(
        lambda: engine.search_batch(queries, threshold, limit, batch_bucket=512)
    )
    print(json.dumps({"traced_batch": trace}), flush=True)
    print(json.dumps({
        "qps_median": N_QUERIES / med, "rep_s": rep_s, "warmup_s": warm_s,
        "routing": routing, "k1_launches": launches,
        "single_query_ms": {"n": N_SINGLE, "p50": single_ms[N_SINGLE // 2],
                            "p90": single_ms[int(N_SINGLE * 0.9)]},
        "peak_mem_search_bytes": peak_search,
        "mean_results": sum(len(k) for k, _ in results) / len(results),
    }), flush=True)
    _phase("main_path", t0, qps=round(N_QUERIES / med, 2), launches=launches)

    # -- 5. K1 on the real table --------------------------------------------
    t0 = time.perf_counter()
    items = []
    for pos, q in enumerate(queries):
        qnorm, qlen = engine._normalize_query(q)
        items.append((pos, qnorm, qlen, None))
    _, _, _, slots, _, _, _ = engine._prep_rows(items, 32)
    gp = int(table.shape[1])
    step = int(routing["step"])
    real_err = 0
    timing = {}
    for b in sorted({256, step}):
        q = query_counts(torch.from_numpy(np_tile(slots, b)).to(dev), gp)
        kh, kb = bmm.bitmap_hits_bmax(q, table)
        rh, rb = bmm.bitmap_hits_bmax_ref(q, table, chunk_tiles=16)
        torch.cuda.synchronize()
        err = max(_max_abs_err(kh, rh), _max_abs_err(kb, rb))
        real_err = max(real_err, err)
        if err or not torch.equal(kh, rh) or not torch.equal(kb, rb):
            raise AssertionError(f"K1 differs on the real table at B={b}: {err}")
        del kh, kb, rh, rb
        torch.cuda.empty_cache()
        k_ms = _cuda_ms(lambda: bmm.bitmap_hits_bmax(q, table), 5)
        p_ms = _cuda_ms(lambda: bmm.bitmap_hits_bmax_ref(q, table, chunk_tiles=16), 1)
        hbytes = b * table.shape[0] * bmm.TILE_LANES
        timing[b] = {
            "k1_ms": k_ms, "plain_ms": p_ms,
            "table_gb_per_s": table.numel() / k_ms / 1e6,
            "hits_gb_per_s": hbytes / k_ms / 1e6,
        }
        torch.cuda.empty_cache()
    print(json.dumps({"k1_timing": timing, "card": smi}), flush=True)
    _phase("k1_real_table", t0, max_abs_err=real_err, step=step)

    # -- 6. exactness against the dense path -----------------------------------
    t0 = time.perf_counter()
    sub = queries[:32]
    dense = engine.search_batch(sub, threshold, limit, batch_bucket=512, mode="dense")
    torch.cuda.synchronize()
    for q, got, want in zip(sub, results[:32], dense):
        if _tie_groups(*got) != _tie_groups(*want):
            raise AssertionError(f"candidate and dense results differ for {q!r}")
    _phase("exactness", t0, queries=len(sub))

    print(json.dumps({"kernels": [{
        "name": "bitmap_hits_bmax",
        "route": "cuda",
        "source": "stringsearchlib_tpu_torch/csrc/bitmap_hits.cu",
        "replaces": "stringsearchlib_tpu/ops/bitmap_matmul.py:401",
        "launches": launches,
        "max_abs_err": max(max_err, real_err),
        "ms": timing[256]["k1_ms"],
        "plain_ms": timing[256]["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count,
    }}), flush=True)


if __name__ == "__main__":
    main()
