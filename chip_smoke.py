#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (stringsearchlib_tpu_torch).

Drives the port's candidate paths on one CUDA card, through
``SearchEngine.search_batch`` and ``SearchEngine.search``:

  * the headline batch search of ``bench.py`` (product-name corpus, uniform
    weights, 512-query batches at threshold 0.3, top-100), which routes to
    the hand-written K1 kernel and the integer h* finish;
  * the gathered-row small-batch route on the same 10M-key index (forced
    with ``BITMAP_GATHER_TMAJ``, as the reference's own tests force it):
    the hand-written row-gather kernel (K3/K4), then K1 on the compact
    table and the h* finish;
  * the weighted 2-D index of ``bench.py`` (``index2d_1m_rows``: 1M rows of
    product name + gram-rich description, weights [1.0, 0.4]), whose packed
    bitmap is over budget, so it routes to the packed bucket sketch through
    the hand-written K2 kernel; on the same index, single queries and
    batches of 8 through the sorted runs (``tiny_runs``: K6's postings
    expansion) and 1-3 character queries through the brute tier (the
    edit-distance DP K5 over the whole long tier);
  * the same 2-D layout at 500k rows, whose packed bitmap fits its budget:
    the weighted bitmap route, K2, ``block_hmax`` and the blockmax finish;
  * ``bench.py``'s ``wide_100k_g2`` (100k CJK/accented keys, gram size 2):
    K2 and the dense-hits finish; and ``wide_100k_g3`` (gram size 3): the
    sorted runs, K6's postings expansion and K5;
  * ``bench.py``'s ``dense_1m`` (1M product names): the gram-matrix route
    (``torch._int_mm``) with the h* finish, batches and single queries;
  * on the 2-D index, the unpacked bucket sketch (``torch._int_mm`` per
    base-128 digit of the bucket counts): phase 8's queries with the packed
    sketch switched off, and queries of more than 127 gram windows, which
    take it by default;
  * on the 10M-key index, persistence and the flat API: ``save`` /
    ``load``, ``capi.loadIndex``, ``capi.score`` and ``cabi``'s C function
    pointers;
  * the sharded engines (``parallel``): the term-sharded engine on the
    10M-key index at 8 and 4 shards of the one card, the gram-sharded and
    DP x TP engines on dense_1m's index, and two processes x two shards
    over gloo.

It also launches the K1 probes P1-P9 (``ops.probes``, the port of the
reference's probe tools) at their tools' full shapes while the 10M-key
table is resident.

Phases, each printing one line with its seconds; any failure raises, so the
script exits non-zero and prints no final ``ok`` line.  They run in the
order 1-3, 15, 4-5, 21, 6, 11-12, 23-24, 7-10, 22, 16, 18-19, 13-14, 17,
20, 25-26:

  1. device: a CUDA card is required; prints nvidia-smi's name and power
     limit;
  2. build: compiles the CUDA sources in csrc/ with nvcc (one process per
     source, started together) and the native index builder with g++, and
     says whether the native builder loaded; prints ptxas's registers and
     spills of K5's instances, of K6's expansion kernel and of the probe
     kernels' instances, and fails on a spill in K5's register instances,
     the expansion kernel or a probe instance, or on a missing instance;
  3. K1 against its plain PyTorch version on random tables (every bit set
     somewhere, bit 7 included; multiplicities summing to 31 and to 127)
     and on the edges of its bit-sliced counters (``_edge_cases``:
     multiplicities above 1 summing to 127, a table with every bit set
     under multiplicity 127, 127 rows of multiplicity 1, B = 1 and 33,
     Gp = 32, Gp = 8192 with bucket collisions): bit-identical hits and
     block maxima; the random cases again on the row-major form of their
     tables;
  4. main path: builds the index on the card (``StringSearchIndex``), runs one warm-up and three
     timed batches of 512 queries, requires the bitmap_kernel + h* route and
     K1 launches; then times 64 single queries;
  5. K1 on the real table: on the whole resident table with real queries'
     counts at B = 256 and at the engine's step, bit-identical to the plain
     version; both timed with CUDA events, the kernel also in device time,
     beside the bound, the listed (query, row) pairs and the integer-issue
     time of the kernel's schedule (``_hits_issue``);
  6. exactness: 32 queries again through the dense path, requiring the
     same (score, key length) tie groups holding the same keys;
  7. K2 against its plain version on random tables (Gp 128 / 2816 / 8192,
     B 16 / 256 / 512, sums 31 / 127), on their row-major form and on phase
     3's edges: bit-identical hits;
  8. 2-D path: builds the weighted 2-D index on the card and its packed
     sketch, runs one warm-up and three timed batches of 1,024 queries,
     requires the sketch_packed route, K2 launches and no plain calls;
  9. K2 on the real sketch table with real queries' bucket counts at
     B = 256 and at the engine's step, bit-identical to the plain version;
     timed as in phase 5;
  10. 2-D exactness: 32 of those queries again through the dense path, the
     same tie groups;
  11. the row gather against its plain version on random tables: row-major
     with NB % 1024 (K3's contract) and NB % 128 only (K4's), tile-major at
     the 10M index's width; Gc 32 / 128 / 512 with duplicate and padding
     rows; torch.equal, both timed with CUDA events;
  12. gathered route on the 10M index: 64 single queries and 8 batches of 8;
     every pass the tiny-runs gate declines must route bitmap_gather with
     h* and >= 32 gathered rows (the rest tiny_runs), with gather and K1
     launches and no plain calls; results equal, as tie groups, the default
     bitmap_kernel route's and the dense path's; single-query p50/p90 on
     both routes; the gather kernel timed on real rows beside
     ``index_select`` and the bound;
  13. weighted bitmap route: the 2-D layout at ``--rows2d-bitmap`` rows
     (500k), its packed table within BITMAP_BUDGET; one warm-up and three
     timed batches of 1,024 queries; route bitmap_kernel, no h*, block_sel,
     no fused block max, K2 launches, no plain calls; 32 queries against the
     dense path; one batch timed fused K1 against K2 + block_hmax, and
     BITMAP_KB_LANES 0 against 65536, with equal results;
  14. wide_100k_g2: 256 queries; route bitmap_kernel, no h*, no block_sel,
     K2 launches; 32 queries against the dense path;
  15. K5 against its plain version on random cases (``K5_CASES``): a
     20k-term short tier at B = 256, a 2M-term long tier at B = 1, wide
     int32 tokens, W = 200 at Qp 32, 33, 65 (uint8 and int32), 129, 130
     and 257, Qp 128 over W 16; qlen 0, 1, Qp - 1 and Qp; bit-identical,
     timed with CUDA events and in device time beside the least-work bound
     (operations at the card's INT32 rate) and the DP-cell bound, with
     the launch plan;
  16. K6's gather against its plain version on random (B, s_cap) indices
     into the 2-D index's gram_terms, out of range on both sides, sorted
     and unsorted, int64 and int32, one and two tables; bit-identical,
     timed per call and in device time beside ``torch.take`` on the
     clamped indices and the bound (distinct 32-byte sectors);
  17. wide_100k_g3: 256 queries; route runs, K5 and postings-expansion
     launches, no plain calls; 32 queries against the dense path; q/s, a
     traced batch, and K5 and the expansion on the very operands a batch
     hands them (recorded) against their plain versions, per call and
     device time, K5's plan; the expansion in turns with the old path (the
     CSR expand, then K6's gather, also checked there) with its launches
     per call and its bound;
  18. tiny runs on the 2-D index: 64 single queries and 8 batches of 8 from
     name and description rows; at least one pass tiny_runs, expansion
     launches, no plain calls; results equal the dense path's; single-query
     p50/p90 on the route and on the dense path; the expansion as in 17 on
     the operands of a description single, a batch of 8 description
     queries (tiny_runs) and the dense comparison's ``gather_hits``;
  19. brute tier on the 2-D index: 16 queries of 1-3 characters; K5
     launches, no plain calls; results equal the same queries recomputed
     with the plain DP; K5 on the long tier at B = 16 and B = 1,
     bit-identical to the plain version, per call and device time;
  20. dense_1m: 1M product names; 512-query batches and 32 single queries,
     each first pass routed matmul with h*; 32 queries against the dense
     path; q/s and single p50/p90;
  21. the K1 probes: P1-P9 against their plain versions at random and edge
     shapes (``_probe_random``), then the probe tools' cases at full shape
     (``_probe_phase``): P1, P8 (B = 256 and 512) and P9's six variants on
     the 10M table in the reference's row-major layout with the headline's
     first 256 queries, P2-P7 on the 2,560-tile synthetic table in both
     layouts; every count set to 0, each case driven once, the counts read;
     then each case held against its plain version and timed (CUDA events
     per call, calls queued behind a spin kernel, the plain version, the
     bound, ``torch.amax`` for P1-P3);
  22. the unpacked sketch on the 2-D index (before it is freed): its table
     (D, bytes, build seconds); (a) phase 8's 1,024 queries with
     SKETCH_PACKED off: every candidate pass ``sketch``, ``_int_mm`` calls
     and no K2, results equal to phase 8's packed-sketch results as tie
     groups, q/s median of 3, a traced batch; (b) 256 queries of more than 127 gram windows
     (``_long_queries_2d``, ``random.Random(13)``) with the defaults: every
     pass ``sketch``, all 256 through the sketch's guard (the rows it sends
     dense counted), results equal to the dense path's on the first 32 and
     to the port's pure-Python oracle on 8 (built over the corpus in a
     spawned process that runs from phase 2 on), q/s, a traced batch; the int32 product
     held against a float32 one on the whole table, ``_int_mm`` per product
     at B = 256 and 512 (CUDA events, queued device ms) beside its bound,
     on the route's column-major table and on a row-major copy;
  23. persistence and the flat API on the 10M-key index (no rebuild):
     ``StringSearchIndex.save`` into a directory under ``build/``, ``load``
     on the card (every array equal), phase 4's batch through the loaded
     engine (the same routing and tie groups, K1 launched, q/s; then the
     built and the loaded engine in turns, three rounds),
     ``capi.loadIndex``, 64 queries through ``capi.score`` with
     ``QueryMetrics`` attached and 32 through ``cabi.function_table()``'s
     score / search / release as C function pointers (equal to the batch's
     results), getSize / getLibSize / dispose; save, load and file bytes
     beside phase 4's build seconds, and ``index_stats``;
  24. the term-sharded engine on the 10M-key index (no rebuild):
     ``shard_index(host, 8)`` (the card's index read to host numpy;
     seconds: the time to recover), a ShardedEngine on ``make_mesh(8,
     device=card)`` (eight shards of the one card, run one after another);
     the headline's 512 queries, one warm-up and three timed batches, every
     pass on the front the budget rule picks (``matmul``, ``torch._int_mm``
     per shard, where G x Tl_c fits GM_BUDGET; else ``runs``, K6's
     expansion per shard), results equal to phase 4's as tie groups with
     their keys, the first 8 to the port's oracle over the rows of the same
     corpus that can score on them (``_oracle_rows``; ``_oracle_child_10m``,
     a spawned process started after phase 1, whose answers are read after
     phase 26); one
     shard's candidate pass and the merge timed with CUDA events on a
     chunk's real operands.  Then the elastic re-shard at S = 4: 64 of the
     queries equal to S = 8's, 16 queries of 1-3 characters (the brute
     tier: K5 per shard) and the wildcard equal to the single engine's.
     Each S prints the bytes per shard on the card (its tensors, and the
     ``memory_allocated`` delta) beside ``utils.capacity``'s plan, q/s
     (median of 3), routing, and K5 / expansion / ``_int_mm`` counts, set
     to 0 before each driven run and read after;
  25. gram-sharded and DP x TP on dense_1m's resident index (after phase
     20): ``GramShardedEngine`` on ``shard_index_by_grams(host, 4)`` and
     ``DpTpEngine`` on ``shard_index_2d(host, 2, 2)``, each on one card:
     256 of phase 20's queries and 16 of 1-3 characters equal to the
     single engine's; the summed TP hits of 8 queries equal to
     ``gather_hits`` on the whole index; K5 and expansion launches;
  26. two processes x two shards over gloo on localhost, both on the one
     card (spawned, each building dense_1m's corpus itself on the CPU):
     256 headline-style queries, then 16 of 1-3 characters and the
     wildcard; both processes' results equal one process's ShardedEngine
     at S = 4 on the resident index; wall and collective seconds per
     process (gloo over host memory, not a multi-card figure).

The line before the last is a JSON object describing the TPU kernels'
ports (K1-K6, the postings expansion, P1-P9); the last line is ``{"ok":
true, "device": {...}}``.

Usage:  python3 chip_smoke.py [--keys N] [--rows2d N] [--rows2d-bitmap N]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import functools
import json
import math
import os
import random
import re
import subprocess
import sys
import time

os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")

_ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _ROOT)
# the card's published peaks, CUDA-event and spin-queued timing, bounds,
# exact comparison: shared with the port's probe tools
from stringsearchlib_tpu_torch.tools.common import PEAK_INT8, hits_bound  # noqa: E402
from stringsearchlib_tpu_torch.tools.common import bound as _bound  # noqa: E402
from stringsearchlib_tpu_torch.tools.common import cuda_ms as _cuda_ms  # noqa: E402
from stringsearchlib_tpu_torch.tools.common import max_abs_err as _max_abs_err  # noqa: E402
from stringsearchlib_tpu_torch.tools.common import queued_ms as _queued_ms  # noqa: E402

_T0 = time.perf_counter()
N_QUERIES = 512  # one batch of the headline (bench.py)
N_QUERIES_2D = 1024  # the 2-D config's query count (bench.py)
REPS = 3
N_SINGLE = 64
N_SMALL_BATCHES = 8  # batches of GATHER_BATCH queries on the gathered route
N_WIDE = 100_000  # bench.py wide_100k_g2 and wide_100k_g3
N_QUERIES_WIDE = 256
N_1M = 1_000_000  # bench.py dense_1m
N_SINGLE_1M = 32
N_BRUTE = 16
THRESHOLD, LIMIT = 0.3, 100  # the headline's (bench.py)
# 32-bit integer ops per SM per clock: the Hopper SM's 64 INT32 lanes
# (NVIDIA H100 Tensor Core GPU Architecture whitepaper, the SM diagram);
# the data sheet lists no integer rate outside the tensor cores
INT32_LANES_PER_SM = 64


@functools.lru_cache(maxsize=None)
def _peak_int32() -> float:
    """32-bit integer ops/s of card 0: its SM count x 64 INT32 lanes x its
    highest SM clock as nvidia-smi reports it."""
    import torch

    mhz = float(subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_LANES_PER_SM * mhz * 1e6


def _phase(name: str, t0: float, **info) -> None:
    extra = " ".join(f"{k}={v}" for k, v in info.items())
    print(
        f"[phase {name}] {time.perf_counter() - t0:.2f}s "
        f"(total {time.perf_counter() - _T0:.1f}s) {extra}",
        flush=True,
    )


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


def _edge_cases(gen, device):
    """The edges of K1/K2's bit-sliced counters, as (name, planes, qcnt):
    multiplicities of 2 and more summing to exactly 127; a table with every
    bit set under one row of multiplicity 127 and under 127 distinct rows of
    multiplicity 1 (every count 127); 127 distinct rows of multiplicity 1 on
    a random table; B = 1 and B = 33 (a ragged last group of 32 queries);
    Gp = 32; Gp = 8192 with sketch-like bucket collisions (pairs of gram
    slots that hash to one bucket, repeated grams, 88 windows a query)."""
    import torch

    from stringsearchlib_tpu_torch.search.candidates import query_counts
    from stringsearchlib_tpu_torch.search.sketch import bucket_of

    def table(gp):
        return torch.randint(-128, 128, (3, gp, 512), generator=gen, dtype=torch.int8)

    def cols(gp, k):
        return torch.randperm(gp, generator=gen)[:k]

    q = torch.zeros((64, 2816), dtype=torch.int32)
    for r in range(64):
        k = 2 + int(torch.randint(0, 20, (1,), generator=gen))
        extra = torch.bincount(torch.randint(0, k, (127 - 2 * k,), generator=gen), minlength=k)
        q[r, cols(2816, k)] = (2 + extra).to(torch.int32)
    cases = [("mults_above_1_sum_127", table(2816), q)]
    q = torch.zeros((2, 256), dtype=torch.int32)
    q[0, 7] = 127
    q[1, cols(256, 127)] = 1
    cases.append(("all_bits_set_127", torch.full((2, 256, 512), -1, dtype=torch.int8), q))
    q = torch.zeros((32, 2816), dtype=torch.int32)
    for r in range(32):
        q[r, cols(2816, 127)] = 1
    cases.append(("127_rows_of_1", table(2816), q))
    cases.append(("b1",) + _random_case(gen, 1, 2816, 3, 127, "cpu"))
    cases.append(("b33",) + _random_case(gen, 33, 2816, 3, 31, "cpu"))
    cases.append(("gp32",) + _random_case(gen, 64, 32, 3, 31, "cpu"))
    pool = torch.arange(200_000, dtype=torch.int32)
    bk = bucket_of(pool, 13)
    order = torch.argsort(bk, stable=True)
    sbk, spool = bk[order], pool[order]
    shared = torch.nonzero(sbk[1:] == sbk[:-1]).flatten() + 1  # i: i-1 and i collide
    pick = shared[torch.randint(0, shared.numel(), (256, 24), generator=gen)]
    slots = torch.cat([spool[pick - 1], spool[pick],
                       torch.randint(0, 200_000, (256, 40), generator=gen, dtype=torch.int32)], 1)
    slots[:, 80:] = slots[:, :8]
    q = query_counts(bucket_of(slots, 13), 1 << 13)
    assert int((q > 1).sum(1).min()) > 0 and int(q.sum(1).max()) == 88
    cases.append(("sketch_8192", table(8192), q))
    for name, _, q in cases:
        assert int(q.sum(1).max()) <= 127, name
    return [(n, p.to(device), c.to(device)) for n, p, c in cases]


def _kernel_of(name: str):
    """'k1' / 'k2' for the instantiations of csrc/bitmap_hits.cu's kernels
    (demangled or mangled name), 'g' for csrc/gather_rows.cu's, 'k5' for
    csrc/dp_match.cu's, 'k6' for either of csrc/gather_tables.cu's, 'probe'
    for the K1 probes', else None."""
    if "gather_rows_kernel" in name:
        return "g"
    if "probe_hits_kernel" in name or "probe_stream_kernel" in name:
        return "probe"
    if "dp_match_kernel" in name:
        return "k5"
    if "gather_tables_kernel" in name or "expand_postings_kernel" in name:
        return "k6"
    if "bitmap_hits_kernel" not in name and "bitmap_hits_rowmajor_kernel" not in name:
        return None
    return "k1" if ("<true>" in name or "ILb1E" in name) else "k2"


def _device_spans(run):
    """``run`` once under torch.profiler: (the profiler, the call's wall
    microseconds, [(start, end, kernel name)] of its device events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
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
    return prof, wall_us, spans


def _trace(run) -> dict:
    """One traced call of ``run`` under torch.profiler: device time by
    kernel name (top 8) and by aten op (top 10), K1's and K2's shares, and
    the device's busy and idle share of the call's wall time (kernel
    intervals merged)."""
    prof, wall_us, spans = _device_spans(run)
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
    short: dict = {}  # printed names are cut; sum the kernels they merge
    for name, v in by_name.items():
        short[name[:100]] = short.get(name[:100], 0.0) + v
    top = sorted(short.items(), key=lambda kv: -kv[1])[:8]
    ops = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        if e.key.startswith("aten::") and t > 0:
            ops.append((e.key, t, e.count))
    ops.sort(key=lambda x: -x[1])
    k1 = sum(v for k, v in by_name.items() if _kernel_of(k) == "k1")
    k2 = sum(v for k, v in by_name.items() if _kernel_of(k) == "k2")
    g = sum(v for k, v in by_name.items() if _kernel_of(k) == "g")
    k5 = sum(v for k, v in by_name.items() if _kernel_of(k) == "k5")
    k6 = sum(v for k, v in by_name.items() if _kernel_of(k) == "k6")
    return {
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy / 1e3,
        "device_idle_share": max(0.0, 1.0 - busy / wall_us),
        "k1_ms": k1 / 1e3,
        "k2_ms": k2 / 1e3,
        "gather_ms": g / 1e3,
        "k5_ms": k5 / 1e3,
        "k6_ms": k6 / 1e3,
        "top_kernels_ms": {k: v / 1e3 for k, v in top},
        "top_ops_device_ms": {f"{k} x{n}": t / 1e3 for k, t, n in ops[:10]},
        "n_kernel_launches": len(spans),
    }


def _device_ms(fn, reps: int = 20):
    """Device-busy milliseconds per call of ``fn`` over ``reps`` calls, from
    a torch.profiler trace (kernel intervals merged): the device's share of
    a call, without the host time a wrapper spends around its launch.  None
    (not measured) when the trace holds fewer kernels than calls: the
    profiler dropped some, and the sum would undercount."""
    t = _trace(lambda: [fn() for _ in range(reps)])
    busy = t.get("device_busy_ms")
    if busy is None or t["n_kernel_launches"] < reps:
        return None
    return busy / reps


def _check_results(results, queries, floor, limit) -> None:
    """One row per query, at most ``limit`` results, every score finite
    and >= ``floor`` (the threshold times the smallest edge weight: the
    threshold gates a term's unweighted score)."""
    if len(results) != len(queries) or any(r is None for r in results):
        raise AssertionError("missing results")
    for keys, scores in results:
        if len(keys) != len(scores) or len(keys) > limit:
            raise AssertionError("malformed result row")
        if any(not (math.isfinite(s) and s >= floor) for s in scores):
            raise AssertionError("non-finite score or score below the floor")


def _check_exact(engine, queries, results, threshold, limit) -> None:
    """The same queries through the dense path: equal (score, key length)
    tie groups holding the same keys."""
    dense = engine.search_batch(
        queries, threshold, limit, batch_bucket=512, mode="dense"
    )
    import torch

    torch.cuda.synchronize()
    for q, got, want in zip(queries, results, dense):
        if _tie_groups(*got) != _tie_groups(*want):
            raise AssertionError(f"candidate and dense results differ for {q!r}")


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


def _reset_counts() -> None:
    """Every kernel's launch and plain-call count to 0."""
    from stringsearchlib_tpu_torch.ops import bitmap_matmul as bmm
    from stringsearchlib_tpu_torch.ops import dp_match as k5
    from stringsearchlib_tpu_torch.ops import probes
    from stringsearchlib_tpu_torch.ops import vgather as k6

    bmm.K1_LAUNCHES = bmm.K1_REF_CALLS = bmm.K2_LAUNCHES = bmm.K2_REF_CALLS = 0
    bmm.G_LAUNCHES = bmm.G_REF_CALLS = 0
    k5.K5_LAUNCHES = k5.K5_REF_CALLS = k6.K6_LAUNCHES = k6.K6_REF_CALLS = 0
    k6.EXPAND_LAUNCHES = 0
    for d in (probes.LAUNCHES, probes.REF_CALLS):
        d.update(dict.fromkeys(d, 0))


def _counts() -> dict:
    from stringsearchlib_tpu_torch.ops import bitmap_matmul as bmm
    from stringsearchlib_tpu_torch.ops import dp_match as k5
    from stringsearchlib_tpu_torch.ops import vgather as k6

    return {
        "k1": bmm.K1_LAUNCHES, "k1_plain": bmm.K1_REF_CALLS,
        "k2": bmm.K2_LAUNCHES, "k2_plain": bmm.K2_REF_CALLS,
        "gather": bmm.G_LAUNCHES, "gather_plain": bmm.G_REF_CALLS,
        "k5": k5.K5_LAUNCHES, "k5_plain": k5.K5_REF_CALLS,
        "k6": k6.K6_LAUNCHES, "k6_plain": k6.K6_REF_CALLS,
        "expand": k6.EXPAND_LAUNCHES,
    }


def _hits_bound(q, ntiles: int, bmax: bool):
    """K1 / K2 on ``q`` (B, Gp) multiplicities over ``ntiles`` tiles: the
    listed rows of the table read once, the multiplicities, the int8 hits
    (and block maxima) written once; two int8 operations per listed
    (query, row, term)."""
    b = q.shape[0]
    nbytes, ops = hits_bound(q, ntiles, b * ntiles * 4096 + (b * ntiles * 32 if bmax else 0))
    return _bound(nbytes, ops, PEAK_INT8)


def _hits_issue(q, ntiles: int) -> dict:
    """K1 / K2's integer issue on ``q`` (B, Gp), beside (never in place of)
    the bound: the instructions per 32-bit word that csrc/bitmap_hits.cu's
    schedule issues for each query's row list - carry-save groups of 8, 4,
    2, 1 rows of multiplicity 1 (a full adder or a half adder is two LOP3,
    the top slice's add one), three per slice for a row of higher
    multiplicity, 60 for the bit transpose - times the 128 words of each
    listed row's tile slice and the tiles, over the card's INT32 rate."""
    ones = (q == 1).sum(1).tolist()
    more = (q > 1).sum(1).tolist()
    sums = q.sum(1).tolist()
    per_slice = 0
    for n1, nm, s in zip(ones, more, sums):
        ns = 4 if s <= 15 else 5 if s <= 31 else 6 if s <= 63 else 7
        g8, r = divmod(int(n1), 8)
        per_slice += (g8 * (2 * ns + 7) + (r >= 4) * (2 * ns + 1)
                      + (r % 4 >= 2) * (2 * ns - 1) + (r % 2) * (2 * ns - 1)
                      + int(nm) * (3 * ns - 1) + 60)
    pairs = int(sum(ones) + sum(more))
    return {
        "listed_pairs": pairs,
        "instr_per_word_row": per_slice / max(pairs, 1),
        "issue_ms": per_slice * 128 * ntiles / _peak_int32() * 1e3,
    }


def _dp_bound(tokens, lengths, qtok, qlens):
    """K5: tokens, lengths, queries read once and the (B, N) int32 counts
    written once; the least integer work for the function at the card's
    INT32 rate: per pair, min(len, W) term characters, each costing the
    cheaper of Sellers' DP column (five 32-bit operations - two min, two
    add, one compare - per query character, 5m) and a step of Myers'
    bit-vector recurrence over ceil(m / 32) words, m = min(qlen, Qp).  The
    step is counted as listed in csrc/dp_match.cu's ``column``, one LOP3
    for each three-input logic term: per word Xv, Xh (and, add, xor-or),
    Ph, Mh, the two shifted deltas, Pv and Mv (10), Eq | Mh-in in every
    word above the lowest (1), and once per step the score's two updates
    and the running minimum (3): 11 ceil(m / 32) + 2.  Returns (ms, what
    bounds it, the DP-cell bound: 5 operations per cell of every pair,
    ms)."""
    import torch

    w, qp = tokens.shape[1], qtok.shape[1]
    m = qlens.clamp(0, qp).double()
    per_char = torch.minimum(5 * m, 11 * torch.ceil(m / 32) + 2)
    chars = float(lengths.clamp(0, w).double().sum())
    nbytes = (tokens.numel() * tokens.element_size() + 4 * lengths.numel()
              + 4 * qtok.numel() + 4 * qlens.numel()
              + 4 * qtok.shape[0] * tokens.shape[0])
    bound, by = _bound(nbytes, float(per_char.sum()) * chars, _peak_int32())
    cell = _bound(nbytes, 5 * float(m.sum()) * chars, _peak_int32())[0]
    return bound, by, cell


def _gather_bound(idx, t_len: int, n_tables: int = 1):
    """K6's gather: the indices read once, each distinct 32-byte sector
    that in-range indices touch read once per table (a sector is the least
    the card reads from device memory), the (B, C) outputs written once per
    table."""
    import torch

    valid = idx[(idx >= 0) & (idx < t_len)]
    sectors = int(torch.unique(valid // 8).numel()) if valid.numel() else 0
    nbytes = (idx.numel() * idx.element_size()
              + n_tables * (32 * sectors + 4 * idx.numel()))
    return _bound(nbytes)


def _expand_bound(gram_ptr, slots, s_cap: int):
    """The postings expansion: the (B, Qmax) slots read once, two gram_ptr
    words per present slot, each distinct 32-byte sector of the rows'
    posting ranges read once, the (B, s_cap) int32 output written once.
    Returns (ms, what bounds it, sectors)."""
    import numpy as np

    sl = slots.cpu().numpy()
    ptr = gram_ptr.cpu().numpy().astype(np.int64)
    present = sl[(sl >= 0) & (sl < ptr.size - 1)]
    u = np.unique(present)
    st, en = ptr[u], ptr[u + 1]
    keep = en > st
    first, last = st[keep] // 8, (en[keep] - 1) // 8
    order = np.argsort(first, kind="stable")
    sectors, reach = 0, -1  # the union of the ranges' sector intervals
    for f, l in zip(first[order].tolist(), last[order].tolist()):
        if l > reach:
            sectors += l - max(f, reach + 1) + 1
            reach = l
    nbytes = (4 * sl.size + 8 * present.size + 32 * sectors
              + 4 * sl.shape[0] * s_cap)
    return (*_bound(nbytes), sectors)


class _bound_as:
    """Every binding ``name`` of the modules ``mods`` set to ``fn`` for the
    ``with`` block (the port's search modules import their kernels' entries
    by name)."""

    def __init__(self, mods, name: str, fn):
        self.mods, self.name, self.fn = mods, name, fn

    def __enter__(self):
        self.saved = [getattr(m, self.name) for m in self.mods]
        for m in self.mods:
            setattr(m, self.name, self.fn)
        return self

    def __exit__(self, *exc):
        for m, f in zip(self.mods, self.saved):
            setattr(m, self.name, f)


def _timed_batches(engine, queries, threshold, limit, reps=REPS):
    """One warm-up and ``reps`` timed batches (host clock, each ended by a
    synchronize): (results, warm-up s, rep s)."""
    import torch

    t1 = time.perf_counter()
    results = engine.search_batch(queries, threshold, limit, batch_bucket=512)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t1
    rep_s = []
    for _ in range(reps):
        t1 = time.perf_counter()
        results = engine.search_batch(queries, threshold, limit, batch_bucket=512)
        torch.cuda.synchronize()
        rep_s.append(time.perf_counter() - t1)
    return results, warm_s, rep_s


def _single_ms(engine, queries, threshold, limit):
    """Each query once through ``SearchEngine.search`` after one warm-up:
    (results, sorted milliseconds)."""
    engine.search(queries[0], threshold, limit)
    out, ms = [], []
    for q in queries:
        t1 = time.perf_counter()
        out.append(engine.search(q, threshold, limit))
        ms.append((time.perf_counter() - t1) * 1e3)
    return out, sorted(ms)


def _with_passes(engine, fn):
    """``fn()`` with every candidate pass of ``engine`` recorded: (fn's
    result, [(items, qp, routing) per pass]).  ``last_routing`` alone shows
    only the last pass, and a retry pass routes at wider budgets."""
    passes = []
    orig = engine._cand_pass

    def spy(items, *a):
        res = orig(items, *a)
        passes.append((list(items), a[3], dict(engine.last_routing)))
        return res

    engine._cand_pass = spy
    try:
        return fn(), passes
    finally:
        del engine._cand_pass


def _pct(sorted_ms, q: float) -> float:
    return sorted_ms[min(int(len(sorted_ms) * q), len(sorted_ms) - 1)]


def _same_groups(a, b, what: str) -> None:
    for i, (x, y) in enumerate(zip(a, b)):
        if _tie_groups(*x) != _tie_groups(*y):
            raise AssertionError(f"{what}: results differ for query {i}")


def _gather_random(gen, dev, ntiles: int):
    """The row gather against its plain version: row-major tables with
    NB % 1024 (K3's contract) and NB % 128 only (K4's), a tile-major table
    of the 10M index's width; Gc 32 / 128 / 512, half of them drawn with
    repeats and the rest padding rows (row 0).  Returns (max_abs_err,
    cases, timing)."""
    import torch
    from stringsearchlib_tpu_torch.ops import bitmap_matmul as bmm

    cases = (
        ("row_major_nb1024", (2816, 8 * 1024)),
        ("row_major_nb128", (2816, 11 * 128)),
        ("tile_major", (ntiles, 256, bmm.BLKB)),
    )
    err, n, timing = 0, 0, {}
    for name, shape in cases:
        table = torch.randint(-128, 128, shape, generator=gen, dtype=torch.int8).to(dev)
        for gc in (32, 128, 512):
            rows = torch.zeros(gc, dtype=torch.int32)
            rows[: gc // 2] = torch.randint(0, shape[-2], (gc // 2,), generator=gen)
            rows = rows.to(dev)
            got = bmm.gather_rows(table, rows)
            want = bmm.gather_rows_ref(table, rows)
            same = torch.equal(got, want)
            if name == "row_major_nb1024":
                same = same and torch.equal(bmm.gather_rows_dma(table, rows), want)
            if name.startswith("row_major"):
                same = same and torch.equal(bmm.gather_rows_pallas(table, rows), want)
            torch.cuda.synchronize()
            e = _max_abs_err(got, want)
            err, n = max(err, e), n + 1
            if e or not same:
                raise AssertionError(f"gather differs from its plain version: {name} "
                                     f"gc={gc} max_abs_err={e}")
            k_ms = _cuda_ms(lambda: bmm.gather_rows(table, rows), 20)
            timing[f"{name}_gc{gc}"] = {
                "shape": list(shape), "ms": k_ms,
                "plain_ms": _cuda_ms(lambda: bmm.gather_rows_ref(table, rows), 5),
                "gb_per_s": 2 * got.numel() / k_ms / 1e6,
            }
            del got, want
        del table
        torch.cuda.empty_cache()
    return err, n, timing


def _gathered_route(engine, table, queries, threshold, limit, dev):
    """The gathered-row route (BITMAP_GATHER_TMAJ) on the 10M index against
    the default full-table route and the dense path."""
    import numpy as np
    import torch
    from stringsearchlib_tpu_torch.ops import bitmap_matmul as bmm

    singles = queries[:N_SINGLE]
    batches = [queries[N_SINGLE + 8 * i : N_SINGLE + 8 * (i + 1)]
               for i in range(N_SMALL_BATCHES)]
    engine.BITMAP_GATHER_TMAJ = False
    want_single, default_ms = _single_ms(engine, singles, threshold, limit)
    want_batches = [engine.search_batch(b, threshold, limit) for b in batches]

    engine.BITMAP_GATHER_TMAJ = True
    engine.search(singles[0], threshold, limit)  # warm-up
    _reset_counts()
    (got_single, got_batches), passes = _with_passes(engine, lambda: (
        [engine.search(q, threshold, limit) for q in singles],
        [engine.search_batch(b, threshold, limit) for b in batches],
    ))
    torch.cuda.synchronize()
    counts = _counts()
    by_variant: dict = {}
    for items, qp, rt in passes:
        s_cap = engine._prep_rows(items, qp)[6]
        tiny = (engine.host.n_terms >= engine.SKETCH_MIN_TERMS
                and len(items) <= engine.RUNS_TINY_BATCH
                and s_cap <= engine.RUNS_TINY_LANES)
        by_variant[rt["variant"]] = by_variant.get(rt["variant"], 0) + 1
        want_v = "tiny_runs" if tiny else "bitmap_gather"
        if rt["variant"] != want_v or not (tiny or rt.get("hstar")):
            raise AssertionError(f"pass of {len(items)} queries (tiny={tiny}) "
                                 f"routed {rt}")
        if not tiny and rt["gather_rows"] < 32:
            raise AssertionError(f"gathered pass with {rt['gather_rows']} rows")
    if not by_variant.get("bitmap_gather"):
        raise AssertionError(f"no pass took the gathered route: {by_variant}")
    if (counts["gather"] <= 0 or counts["k1"] <= 0 or counts["gather_plain"]
            or counts["k1_plain"] or counts["k5_plain"] or counts["k6_plain"]):
        raise AssertionError(f"gathered route counts {counts}")
    _, gather_ms = _single_ms(engine, singles, threshold, limit)
    engine.BITMAP_GATHER_TMAJ = False

    _same_groups(got_single, want_single, "gathered vs bitmap_kernel (single)")
    got_flat = [r for b in got_batches for r in b]
    _same_groups(got_flat, [r for b in want_batches for r in b],
                 "gathered vs bitmap_kernel (batches of 8)")
    dense = engine.search_batch(singles + [q for b in batches for q in b],
                                threshold, limit, batch_bucket=512, mode="dense")
    _same_groups(got_single + got_flat, dense, "gathered vs dense")
    _check_results(got_single + got_flat, singles + [q for b in batches for q in b],
                   threshold, limit)

    # the gather kernel on a real batch's rows
    items = []
    for pos, q in enumerate(batches[0]):
        qnorm, qlen = engine._normalize_query(q)
        items.append((pos, qnorm, qlen, None))
    slots = engine._prep_rows(items, 32)[3]
    rows, _, gc = engine._gather_rows_plan(slots)
    n_union = int(np.unique(slots[slots >= 0]).size)
    rows_d = torch.from_numpy(rows).to(dev)
    kg = bmm.gather_rows(table, rows_d)
    rg = bmm.gather_rows_ref(table, rows_d)
    torch.cuda.synchronize()
    err = _max_abs_err(kg, rg)
    if err or not torch.equal(kg, rg):
        raise AssertionError(f"gather differs on the real table's rows: {err}")
    g_ms = _cuda_ms(lambda: bmm.gather_rows(table, rows_d), 20)
    rows_l = rows_d.long()
    # each distinct listed row read once, the (padded) output written once
    row_bytes = kg.numel() // rows_d.numel()
    g_bound = _bound(int(torch.unique(rows_d).numel()) * row_bytes + kg.numel()
                     + 4 * rows_d.numel())
    return {
        "passes_by_variant": by_variant,
        "gather_launches": counts["gather"],
        "k1_launches": counts["k1"],
        "counts": counts,
        "single_query_ms": {
            "n": len(singles),
            "gathered": {"p50": _pct(gather_ms, 0.5), "p90": _pct(gather_ms, 0.9)},
            "bitmap_kernel": {"p50": _pct(default_ms, 0.5), "p90": _pct(default_ms, 0.9)},
        },
        "gather_real_rows": {
            "gc": int(gc), "union_rows": n_union,
            "table_shape": list(table.shape), "ms": g_ms,
            "plain_ms": _cuda_ms(lambda: bmm.gather_rows_ref(table, rows_d), 5),
            "gb_per_s": 2 * kg.numel() / g_ms / 1e6,
            "device_ms": _device_ms(lambda: bmm.gather_rows(table, rows_d)),
            "plain_device_ms": _device_ms(lambda: bmm.gather_rows_ref(table, rows_d)),
            "index_select_ms": _cuda_ms(lambda: table.index_select(1, rows_l), 20),
            "bound_ms": g_bound[0], "bound_by": g_bound[1],
        },
        "max_abs_err": err,
    }


def _weighted_bitmap_route(n_rows: int, threshold, limit, dev):
    """bench.py's 2-D layout at ``n_rows`` rows, whose packed bitmap fits
    BITMAP_BUDGET: the weighted bitmap route (K2, block_hmax, blockmax
    finish), the dense check, and one batch timed each way for the fused
    block max and BITMAP_KB_LANES."""
    import numpy as np
    import torch

    import bench
    from stringsearchlib_tpu_torch.config import IndexConfig
    from stringsearchlib_tpu_torch.index import build as buildmod
    from stringsearchlib_tpu_torch.search.engine import SearchEngine

    t0 = time.perf_counter()
    rows = bench._product_names(n_rows, seed=5)
    descs = bench._rich_names(n_rows, seed=6)
    words = [x for kv in zip(rows, descs) for x in kv]
    del rows, descs
    weights = np.tile(np.array([1.0, 0.4]), n_rows)
    corpus_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    host = buildmod.build_index(words, 2, weights, IndexConfig(), device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t1
    engine = SearchEngine(host)
    if not host.bitmap_fits(engine.BITMAP_BUDGET):
        raise AssertionError(f"the {n_rows}-row packed bitmap is over BITMAP_BUDGET")
    t1 = time.perf_counter()
    bm = host.bitmap_tables(engine.BITMAP_BUDGET)
    torch.cuda.synchronize()
    table_s = time.perf_counter() - t1
    info = {
        "n_rows": n_rows, "n_terms": host.n_terms, "n_grams": host.n_grams,
        "uniform_weights": host.uniform_weights, "corpus_s": corpus_s,
        "build_s": build_s, "bitmap_table_s": table_s,
        "bitmap_bytes": int(bm[0].numel()), "table_shape": list(bm[0].shape),
        "budget_bytes": int(engine.BITMAP_BUDGET),
        "peak_mem_build_bytes": int(torch.cuda.max_memory_allocated()),
    }
    rng = random.Random(7)
    queries = [bench._mutate(rng, rng.choice(words)) for _ in range(N_QUERIES_2D)]
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    (results, warm_s, rep_s), passes = _with_passes(
        engine, lambda: _timed_batches(engine, queries, threshold, limit)
    )
    counts = _counts()
    routing = passes[0][2]
    if (routing.get("variant") != "bitmap_kernel" or routing.get("hstar")
            or routing.get("fused_bmax") or not routing.get("block_sel")):
        raise AssertionError(f"the weighted index did not take bitmap_kernel + blockmax: {routing}")
    if counts["k2"] <= 0 or counts["k1"] or counts["k2_plain"] or counts["k1_plain"]:
        raise AssertionError(f"weighted route counts {counts}")
    _check_results(results, queries, threshold * 0.4 * (1 - 1e-6), limit)
    med = sorted(rep_s)[len(rep_s) // 2]
    info.update(
        qps_median=N_QUERIES_2D / med, rep_s=rep_s, warmup_s=warm_s,
        routing_first_pass=routing, routing_last=dict(engine.last_routing),
        k2_launches=counts["k2"], counts=counts,
        peak_mem_search_bytes=int(torch.cuda.max_memory_allocated()),
        mean_results=sum(len(k) for k, _ in results) / len(results),
        traced_batch=_trace(lambda: engine.search_batch(
            queries, threshold, limit, batch_bucket=512)),
    )
    _check_exact(engine, queries[:32], results[:32], threshold, limit)

    # one 512-query batch each way: K2 + block_hmax (the default) against
    # the fused K1 block max, and the kept-lane budget 0 against 65536
    half = queries[:512]
    base = None
    cells = {}
    for name, setting in (
        ("k2_block_hmax", {}), ("k1_fused", {"BITMAP_FUSED_BMAX": True}),
        ("kb_lanes_65536", {"BITMAP_KB_LANES": 65536}),
        ("k2_block_hmax_again", {}),
    ):
        for k, v in setting.items():
            setattr(engine, k, v)
        engine.search_batch(half, threshold, limit, batch_bucket=512)
        torch.cuda.synchronize()
        _reset_counts()
        ms = []
        for _ in range(2):
            t1 = time.perf_counter()
            res = engine.search_batch(half, threshold, limit, batch_bucket=512)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
        tr = _trace(lambda: engine.search_batch(half, threshold, limit, batch_bucket=512))
        cells[name] = {
            "host_ms": ms, "counts": _counts(),
            "fused_bmax": engine.last_routing.get("fused_bmax"),
            "retry_fast": engine.last_routing.get("retry_fast"),
            "device_busy_ms": tr.get("device_busy_ms"), "wall_ms": tr.get("wall_ms"),
            "k1_ms": tr.get("k1_ms"), "k2_ms": tr.get("k2_ms"),
        }
        for k in setting:
            delattr(engine, k)
        if base is None:
            base = res
        else:
            _same_groups(res, base, f"weighted batch {name} vs k2_block_hmax")
    if not cells["k1_fused"]["counts"]["k1"] or cells["k1_fused"]["counts"]["k2"]:
        raise AssertionError(f"the fused setting did not run K1: {cells['k1_fused']}")
    info["one_batch_each_way"] = cells
    del engine, host, bm, results
    return info


def _wide_g2_route(threshold, limit, dev):
    """bench.py's wide_100k_g2: 100k wide keys at gram size 2, 256 queries;
    the bitmap route without h* or block selection (K2, dense-hits
    finish)."""
    import torch

    import bench
    from stringsearchlib_tpu_torch.config import IndexConfig
    from stringsearchlib_tpu_torch.index import build as buildmod
    from stringsearchlib_tpu_torch.search.engine import SearchEngine

    words = bench._wide_names(N_WIDE)
    t1 = time.perf_counter()
    host = buildmod.build_index(
        words, 1, None, IndexConfig(wide=True, gram_size=2), device=dev
    )
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t1
    engine = SearchEngine(host)
    rng = random.Random(7)
    queries = [bench._mutate(rng, rng.choice(words)) for _ in range(N_QUERIES_WIDE)]
    _reset_counts()
    (results, warm_s, rep_s), passes = _with_passes(
        engine, lambda: _timed_batches(engine, queries, threshold, limit)
    )
    counts = _counts()
    routing = passes[0][2]
    if (routing.get("variant") != "bitmap_kernel" or routing.get("hstar")
            or routing.get("block_sel")):
        raise AssertionError(f"wide_100k_g2 did not take bitmap_kernel + dense hits: {routing}")
    if counts["k2"] <= 0 or counts["k2_plain"] or counts["k1_plain"]:
        raise AssertionError(f"wide_100k_g2 counts {counts}")
    _check_results(results, queries, threshold, limit)
    _check_exact(engine, queries[:32], results[:32], threshold, limit)
    med = sorted(rep_s)[len(rep_s) // 2]
    bm = host.bitmap_tables(engine.BITMAP_BUDGET)
    return {
        "n_keys": len(words), "n_terms": host.n_terms, "n_grams": host.n_grams,
        "build_s": build_s, "table_shape": list(bm[0].shape),
        "qps_median": N_QUERIES_WIDE / med, "rep_s": rep_s, "warmup_s": warm_s,
        "routing_first_pass": routing, "routing_last": dict(engine.last_routing),
        "k2_launches": counts["k2"], "counts": counts,
        "mean_results": sum(len(k) for k, _ in results) / len(results),
    }


# K5's random cases: (name, N terms, width W, B queries, Qp, wide tokens);
# the qlens include Qp and Qp - 1, so the W = 200 cases put queries on both
# sides of each word-count boundary (32/33, 64/65, 128/129)
K5_CASES = (
    ("short_tier_b256", 20_000, 8, 256, 32, False),
    ("long_tier_b1", 2_000_000, 32, 1, 32, False),
    ("wide_int32_b64", 100_000, 16, 64, 16, True),
    ("w200_qp32_b16", 20_000, 200, 16, 32, False),
    ("w200_qp33_b16", 20_000, 200, 16, 33, False),
    ("w200_qp65_b16", 20_000, 200, 16, 65, False),
    ("w200_qp65_int32_b16", 20_000, 200, 16, 65, True),
    ("w200_qp129_b16", 5_000, 200, 16, 129, False),
    ("w200_qp130_b4", 5_000, 200, 4, 130, False),
    ("w200_qp257_b4", 5_000, 200, 4, 257, False),  # the scratch kernel
    ("qp128_w16_b64", 20_000, 16, 64, 128, False),
)


def _k5_case(gen, n: int, w: int, b: int, qp: int, wide: bool, dev):
    """Random K5 operands over a 6-letter alphabet: lengths 0..W (0 and W
    included), qlens Qp, 0, 1, Qp - 1, then random; padding 0."""
    import torch

    lo = 0x4E00 if wide else ord("a")
    lengths = torch.randint(0, w + 1, (n,), generator=gen, dtype=torch.int32)
    lengths[:2] = torch.tensor([0, w])
    tokens = torch.randint(lo, lo + 6, (n, w), generator=gen, dtype=torch.int32)
    tokens[torch.arange(w)[None, :] >= lengths[:, None]] = 0
    qlens = torch.randint(0, qp + 1, (b,), generator=gen, dtype=torch.int32)
    qlens[: min(b, 4)] = torch.tensor([qp, 0, 1, qp - 1])[: min(b, 4)]
    qtok = torch.randint(lo, lo + 6, (b, qp), generator=gen, dtype=torch.int32)
    qtok[torch.arange(qp)[None, :] >= qlens[:, None]] = 0
    if not wide:
        tokens = tokens.to(torch.uint8)
    return [t.to(dev) for t in (tokens, lengths, qtok, qlens)]


def _k5_instances(log: str) -> dict:
    """{instance ("uint8 nw=1 qc=16", ..., "int32 scratch"): registers and
    spill bytes} of csrc/dp_match.cu's kernels from ptxas's log, read by
    hits_ab._ptxas."""
    import re

    import hits_ab

    res = {}
    for fn, (regs, stores, loads) in hits_ab._ptxas(log).items():
        k = re.search(r"dp_match(_words)?_kernelI([hi])(?:Li(\d+)ELi(\d+)E)?", fn)
        if k:
            name = "uint8" if k.group(2) == "h" else "int32"
            name += " scratch" if k.group(1) else f" nw={k.group(3)} qc={k.group(4)}"
            res[name] = {"registers": regs, "spill_stores": stores, "spill_loads": loads}
    return res


def _k5_plan(args) -> dict:
    """The launch ``dp_match`` picks for ``args`` (ops.dp_match.plan)."""
    from stringsearchlib_tpu_torch.ops import dp_match as k5

    tokens, _, qtok, _ = args
    return k5.plan(int(qtok.shape[1]), int(tokens.shape[0]), int(qtok.shape[0]))


def _k5_random(gen, dev):
    """K5 against its plain version on random cases at the shapes the routes
    give it (K5_CASES): a 20k-term short tier at B = 256, a 2M-term long
    tier at B = 1, wide int32 tokens, W = 200 with queries on both sides of
    each word-count boundary and past 8 words (the scratch kernel), Qp 128
    over W 16; qlen 0, 1, Qp - 1 and Qp in every case.  Returns
    (max_abs_err, cases, timing)."""
    import torch
    from stringsearchlib_tpu_torch.ops import dp_match as k5

    err, timing = 0, {}
    for name, n, w, b, qp, wide in K5_CASES:
        args = _k5_case(gen, n, w, b, qp, wide, dev)
        got = k5.dp_match(*args)
        want = k5.dp_match_ref(*args)
        torch.cuda.synchronize()
        e = int((got - want).abs().max())
        err = max(err, e)
        if e or not torch.equal(got, want):
            raise AssertionError(f"K5 differs from its plain version: {name} max_abs_err={e}")
        bound, by, cell = _dp_bound(*args)
        timing[name] = {
            "n": n, "w": w, "b": b, "qp": qp, "wide": wide,
            "ms": _cuda_ms(lambda: k5.dp_match(*args), 5),
            "device_ms": _queued_ms(lambda: k5.dp_match(*args), 5),
            "plain_ms": _cuda_ms(lambda: k5.dp_match_ref(*args), 1),
            "bound_ms": bound, "bound_by": by, "dp_cell_bound_ms": cell,
            "plan": _k5_plan(args),
        }
        del got, want, args
        torch.cuda.empty_cache()
    return err, len(K5_CASES), timing


def _gather_case(idx, tables, fills, what: str) -> dict:
    """K6 against its plain version on one case, bit for bit, and both timed
    with CUDA events (per call, host work included) and from a trace
    (device time) beside ``torch.take`` on the clamped indices (the nearest
    library call: no fill) and the bound."""
    import torch
    from stringsearchlib_tpu_torch.ops import vgather as k6

    got = k6.gather_tables(idx, tables, fills)
    want = k6.gather_tables_ref(idx, tables, fills)
    torch.cuda.synchronize()
    err = 0  # over the outputs' 32-bit patterns
    for g, w in zip(got, want):
        gb, wb = g.view(torch.int32), w.view(torch.int32)
        err = max(err, int((gb.long() - wb.long()).abs().max()))
        if g.dtype != w.dtype or err or not torch.equal(gb, wb):
            raise AssertionError(f"K6 differs from its plain version: {what} "
                                 f"max_abs_err={err}")
    del got, want
    t_len = int(tables[0].shape[0])
    idc = idx.clamp(0, t_len - 1).long()
    bound, by = _gather_bound(idx, t_len, len(tables))
    return {
        "shape": list(idx.shape), "index_dtype": str(idx.dtype).replace("torch.", ""),
        "tables": len(tables), "table_len": t_len, "max_abs_err": err,
        "ms": _cuda_ms(lambda: k6.gather_tables(idx, tables, fills), 10),
        "plain_ms": _cuda_ms(lambda: k6.gather_tables_ref(idx, tables, fills), 3),
        "take_ms": _cuda_ms(lambda: torch.take(tables[0], idc), 10),
        "device_ms": _queued_ms(lambda: k6.gather_tables(idx, tables, fills)),
        "plain_device_ms": _device_ms(lambda: k6.gather_tables_ref(idx, tables, fills), 5),
        "take_device_ms": _device_ms(lambda: torch.take(tables[0], idc)),
        "bound_ms": bound, "bound_by": by,
    }


def _kernels_per_call(fn, reps: int = 5) -> dict:
    """Kernel launches per call of ``fn`` from one torch.profiler trace of
    ``reps`` calls: the runtime's launch calls on the host and the kernels
    the device ran (the profiler can drop device kernels late in a long
    process, so both are given)."""
    prof, _, spans = _device_spans(lambda: [fn() for _ in range(reps)])
    host = sum(1 for e in prof.events()
               if e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
    return {"host_launch_calls": host / reps, "device_kernels": len(spans) / reps}


def _in_turns(sides: dict, timer) -> dict:
    """``timer`` on each of ``sides`` ({name: fn}) in order, then in reverse
    (old, new, new, old): {name: its two readings}."""
    names = list(sides)
    res = {n: [] for n in names}
    for n in names + names[::-1]:
        res[n].append(timer(sides[n]))
    return res


def _mean(xs):
    xs = [x for x in xs if x is not None]
    return sum(xs) / len(xs) if xs else None


def _old_expansion(gram_ptr, gram_terms, slots, s_cap: int, fill: int):
    """The expansion as the port ran it before ``expand_postings``: the
    eager CSR expand ``posting_index``, then K6's gather kernel at its
    indices."""
    from stringsearchlib_tpu_torch.ops import vgather as k6

    idx = k6.posting_index(gram_ptr, slots, s_cap)
    return k6.gather_tables(idx, [gram_terms], [fill])[0]


def _expand_case(args, what: str, reps: int = 20) -> dict:
    """The postings expansion on one recorded operand set (gram_ptr,
    gram_terms, slots, s_cap, fill): the kernel bit-identical to
    ``expand_postings_ref`` and to the old path (the CSR expand
    ``posting_index``, then the gather kernel); kernel and old path timed in
    turns with CUDA events per call (host work included) and in device time
    (calls queued behind a spin kernel); launches per expansion; the plain
    version's time; the bound."""
    import torch
    from stringsearchlib_tpu_torch.ops import vgather as k6

    ptr, terms, slots, s_cap, fill = args

    def new():
        return k6.expand_postings(*args)

    def old():
        return _old_expansion(*args)

    n0 = (k6.EXPAND_LAUNCHES, k6.K6_REF_CALLS)
    got = new()
    if (k6.EXPAND_LAUNCHES - n0[0], k6.K6_REF_CALLS - n0[1]) != (1, 0):
        raise AssertionError(f"the expansion did not launch its kernel once: {what}")
    want = k6.expand_postings_ref(*args)
    was = old()
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    if err or not torch.equal(got, want) or not torch.equal(was, want):
        raise AssertionError(f"the expansion differs from its plain version: {what} "
                             f"max_abs_err={err}")
    del got, want, was
    torch.cuda.empty_cache()
    bound, by, sectors = _expand_bound(ptr, slots, s_cap)
    ms = _in_turns({"old": old, "new": new}, lambda f: _cuda_ms(f, reps))
    dev_ms = _in_turns({"old": old, "new": new}, lambda f: _queued_ms(f, reps))
    return {
        "shape": [int(slots.shape[0]), int(slots.shape[1]), int(s_cap)],
        "present_slots": int((slots >= 0).sum()), "posting_sectors": sectors,
        "postings": int(terms.shape[0]), "max_abs_err": err,
        "ms": _mean(ms["new"]), "device_ms": _mean(dev_ms["new"]),
        "old_path_ms": _mean(ms["old"]), "old_path_device_ms": _mean(dev_ms["old"]),
        "turns_ms": ms, "turns_device_ms": dev_ms,
        "plain_ms": _cuda_ms(lambda: k6.expand_postings_ref(*args), 3),
        "launches_per_expansion": {"new": _kernels_per_call(new),
                                   "old": _kernels_per_call(old)},
        "bound_ms": bound, "bound_by": by,
    }


def _k6_random(gram_terms, dev):
    """K6 against its plain version on random (B, s_cap) indices into a
    real ``gram_terms`` (the 2-D index's), out of range on both sides:
    sorted int64 rows as the postings expansions pass them, unsorted ones,
    and int32 indices over two tables (int32 and float32).  Returns
    (cases, timing)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(66)
    t_len = int(gram_terms.shape[0])
    ftab = torch.randn(t_len, generator=gen, device=dev)
    timing = {}
    for name, b, c, ordered, dt, two in (
        ("b256_c65536_sorted_int64", 256, 1 << 16, True, torch.int64, False),
        ("b8_c1048576_unsorted_int64", 8, 1 << 20, False, torch.int64, False),
        ("b64_c65536_int32_two_tables", 64, 1 << 16, False, torch.int32, True),
    ):
        idx = torch.randint(-1000, t_len + 1000, (b, c), generator=gen, device=dev,
                            dtype=torch.int64)
        if ordered:
            idx = torch.sort(idx, dim=1).values
        idx = idx.to(dt).contiguous()
        tables = [gram_terms, ftab] if two else [gram_terms]
        fills = [t_len, -1.5] if two else [t_len]
        timing[name] = _gather_case(idx, tables, fills, name)
        del idx
    return len(timing), timing


def _recorded_calls(mod, name: str, run) -> list:
    """``run()`` with ``mod.<name>`` spied on: the arguments of every call
    it got, top-level tensors cloned (the engine may reuse its buffers)."""
    import torch

    calls, orig = [], getattr(mod, name)

    def spy(*a):
        calls.append(tuple(x.clone() if torch.is_tensor(x) else x for x in a))
        return orig(*a)

    setattr(mod, name, spy)
    try:
        run()
    finally:
        setattr(mod, name, orig)
    return calls


def _route_kernels(engine, run) -> dict:
    """K5 and K6 at a runs route's real shapes: the operands that the first
    candidate pass of ``run()`` hands to the short tier's ``dp_match`` and
    to ``expand_postings``, recorded as they are passed; each kernel
    against its plain version, bit for bit, with CUDA-event and device
    times, the bounds, and K5's launch plan; the expansion against the old
    path (``_expand_case``), and the gather kernel at the old path's
    indices."""
    import torch
    from stringsearchlib_tpu_torch.ops import dp_match as k5
    from stringsearchlib_tpu_torch.ops import vgather as k6
    from stringsearchlib_tpu_torch.search import candidates

    k6_calls = []
    dp_calls = _recorded_calls(candidates, "dp_match", lambda: k6_calls.extend(
        _recorded_calls(candidates, "expand_postings", run)))
    if not dp_calls or not k6_calls:
        raise AssertionError(f"the route made {len(dp_calls)} short-tier DP and "
                             f"{len(k6_calls)} expansion calls")
    dp_args = dp_calls[0]
    kd, pd = k5.dp_match(*dp_args), k5.dp_match_ref(*dp_args)
    torch.cuda.synchronize()
    if not torch.equal(kd, pd):
        raise AssertionError("K5 differs from its plain version on the route's shapes")
    bound, by, cell = _dp_bound(*dp_args)
    tokens, qtok = dp_args[0], dp_args[2]
    k5_info = {
        "calls_per_batch": len(dp_calls),
        "shape": [int(qtok.shape[0]), int(tokens.shape[0]), int(tokens.shape[1])],
        "qp": int(qtok.shape[1]), "token_dtype": str(tokens.dtype).replace("torch.", ""),
        "ms": _cuda_ms(lambda: k5.dp_match(*dp_args), 10),
        "plain_ms": _cuda_ms(lambda: k5.dp_match_ref(*dp_args), 3),
        "device_ms": _queued_ms(lambda: k5.dp_match(*dp_args)),
        "plain_device_ms": _device_ms(lambda: k5.dp_match_ref(*dp_args), 5),
        "bound_ms": bound, "bound_by": by, "dp_cell_bound_ms": cell,
        "plan": _k5_plan(dp_args),
    }
    ptr, terms, slots, s_cap, fill = k6_calls[0]
    idx = k6.posting_index(ptr, slots, s_cap)
    k6_info = _gather_case(idx, [terms], [fill], "the route's expansion indices")
    del idx
    expand = _expand_case(k6_calls[0], "the wide g3 route")
    expand["calls_per_batch"] = len(k6_calls)
    return {"k5": k5_info, "k6": k6_info, "expand": expand}


def _wide_g3_route(threshold, limit, dev):
    """bench.py's wide_100k_g3: 100k wide keys at gram size 3, 256 queries.
    The packed bitmap is over BITMAP_BUDGET and the index under
    SKETCH_MIN_TERMS, so the batch takes the sorted runs: K6 expands the
    postings, K5 scores the short tier."""
    import torch

    import bench
    from stringsearchlib_tpu_torch.config import IndexConfig
    from stringsearchlib_tpu_torch.index import build as buildmod
    from stringsearchlib_tpu_torch.search.engine import SearchEngine

    words = bench._wide_names(N_WIDE)
    t1 = time.perf_counter()
    host = buildmod.build_index(
        words, 1, None, IndexConfig(wide=True, gram_size=3), device=dev
    )
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t1
    engine = SearchEngine(host)
    rng = random.Random(7)
    queries = [bench._mutate(rng, rng.choice(words)) for _ in range(N_QUERIES_WIDE)]
    _reset_counts()
    (results, warm_s, rep_s), passes = _with_passes(
        engine, lambda: _timed_batches(engine, queries, threshold, limit)
    )
    counts = _counts()
    routing = passes[0][2]
    if routing.get("variant") != "runs":
        raise AssertionError(f"wide_100k_g3 did not take the sorted runs: {routing}")
    if (counts["k5"] <= 0 or counts["expand"] <= 0 or counts["k5_plain"]
            or counts["k6_plain"]):
        raise AssertionError(f"wide_100k_g3 counts {counts}")
    _check_results(results, queries, threshold, limit)
    _check_exact(engine, queries[:32], results[:32], threshold, limit)
    med = sorted(rep_s)[len(rep_s) // 2]
    return {
        "n_keys": len(words), "n_terms": host.n_terms, "n_grams": host.n_grams,
        "n_short": host.device.n_short, "build_s": build_s,
        "bitmap_fits": host.bitmap_fits(engine.BITMAP_BUDGET),
        "qps_median": N_QUERIES_WIDE / med, "rep_s": rep_s, "warmup_s": warm_s,
        "routing_first_pass": routing, "routing_last": dict(engine.last_routing),
        "counts": counts,
        "mean_results": sum(len(k) for k, _ in results) / len(results),
        "traced_batch": _trace(lambda: engine.search_batch(
            queries, threshold, limit, batch_bucket=512)),
        "route_kernels": _route_kernels(engine, lambda: engine.search_batch(
            queries, threshold, limit, batch_bucket=512)),
    }


def _spied(engine, queries, run):
    """``run(q)`` for each query with the candidate passes recorded: (the
    results, each query's first-pass routing, {"variant": "none"} where no
    candidate pass ran)."""
    out, variants = [], []
    orig = engine._cand_pass
    seen = []

    def spy(items, *a):
        res = orig(items, *a)
        seen.append(dict(engine.last_routing))
        return res

    engine._cand_pass = spy
    try:
        for q in queries:
            n0 = len(seen)
            out.append(run(q))
            variants.append(seen[n0] if len(seen) > n0 else {"variant": "none"})
    finally:
        del engine._cand_pass
    return out, variants


def _tiny_queries(words):
    """The 2-D phase's queries (random.Random(11)): 64 singles, name and
    description rows in turn, and 8 batches of 4 name and 4 description
    queries."""
    import bench

    rng = random.Random(11)
    half = len(words) // 2

    def draw(kind, n):
        return [bench._mutate(rng, words[2 * rng.randrange(half) + kind]) for _ in range(n)]

    singles = [q for pair in zip(draw(0, 32), draw(1, 32)) for q in pair]
    return singles, [draw(0, 4) + draw(1, 4) for _ in range(N_SMALL_BATCHES)]


def _expansion_operands(engine, allq, desc, threshold, limit):
    """The arguments ``expand_postings`` is handed by the dense path's
    ``gather_hits`` over ``allq`` (its first chunk), by a single query
    ``desc[0]`` and by a batch ``desc[:8]`` on tiny_runs, recorded: ({name:
    args}, the dense path's results, its expansion calls)."""
    from stringsearchlib_tpu_torch.search import candidates, overlap

    dense = []
    dense_calls = _recorded_calls(overlap, "expand_postings", lambda: dense.extend(
        engine.search_batch(allq, threshold, limit, batch_bucket=512, mode="dense")))
    single_calls = _recorded_calls(candidates, "expand_postings",
                                   lambda: engine.search(desc[0], threshold, limit))
    batch_calls = _recorded_calls(candidates, "expand_postings",
                                  lambda: engine.search_batch(desc[:8], threshold, limit))
    if not (dense_calls and single_calls and batch_calls):
        raise AssertionError(f"recorded expansions: dense {len(dense_calls)}, single "
                             f"{len(single_calls)}, batch of 8 {len(batch_calls)}")
    ops = {"desc_single": single_calls[0], "desc_batch_of_8": batch_calls[0],
           "dense_gather_hits": dense_calls[0]}
    return ops, dense, len(dense_calls)


def _tiny_runs_2d(engine, words, threshold, limit):
    """64 single queries and 8 batches of 8 on the 1M-row 2-D index, half
    from name rows and half from description rows: passes whose posting
    mass fits RUNS_TINY_LANES take tiny_runs (no table streamed), the rest
    the sketch.  Results equal the dense path's; single-query times on the
    route against the dense path (which the port took before the runs
    route existed).  The postings expansion on the operands recorded from
    one description single and one batch of 8 description queries on
    tiny_runs, and from the dense comparison's ``gather_hits``
    (``_expand_case``)."""
    import torch

    singles, batches = _tiny_queries(words)
    engine.search(singles[0], threshold, limit)  # warm-up
    _reset_counts()
    got_single, r_single = _spied(
        engine, singles, lambda q: engine.search(q, threshold, limit))
    got_batches, r_batches = _spied(
        engine, batches, lambda b: engine.search_batch(b, threshold, limit))
    v_single = [rt["variant"] for rt in r_single]
    v_batches = [rt["variant"] for rt in r_batches]
    torch.cuda.synchronize()
    counts = _counts()
    if "tiny_runs" not in v_single + v_batches:
        raise AssertionError(f"no pass took tiny_runs: {v_single} {v_batches}")
    if (counts["expand"] <= 0 or counts["k6_plain"] or counts["k5_plain"]
            or counts["k2_plain"]):
        raise AssertionError(f"tiny_runs_2d counts {counts}")
    flat = [r for b in got_batches for r in b]
    allq = singles + [q for b in batches for q in b]
    ops, dense, n_dense = _expansion_operands(engine, allq, singles[1::2], threshold, limit)
    expand = {name: _expand_case(a, name, reps=5 if name.startswith("dense") else 20)
              for name, a in ops.items()}
    expand["dense_gather_hits"]["calls"] = n_dense
    del ops
    torch.cuda.empty_cache()
    _same_groups(got_single + flat, dense, "tiny_runs_2d vs dense")
    _check_results(got_single + flat, allq, threshold * 0.4 * (1 - 1e-6), limit)
    _, route_ms = _single_ms(engine, singles, threshold, limit)
    dense_ms = []
    for q in singles:
        t1 = time.perf_counter()
        engine.search_batch([q], threshold, limit, mode="dense")
        dense_ms.append((time.perf_counter() - t1) * 1e3)
    dense_ms.sort()
    tally = {}
    for kind, vs in (("name_singles", v_single[0::2]), ("desc_singles", v_single[1::2]),
                     ("batches_of_8", v_batches)):
        tally[kind] = {v: vs.count(v) for v in sorted(set(vs))}
    return {
        "first_pass_variants": tally, "counts": counts,
        "single_query_ms": {
            "n": len(singles),
            "route": {"p50": _pct(route_ms, 0.5), "p90": _pct(route_ms, 0.9)},
            "dense": {"p50": _pct(dense_ms, 0.5), "p90": _pct(dense_ms, 0.9)},
        },
        "traced_single_desc": _trace(lambda: engine.search(singles[1], threshold, limit)),
        "expand": expand,
    }


def _brute_queries(engine, words, dev):
    """N_BRUTE queries of 1-3 characters cut from ``words`` (random.Random
    13), and their (N_BRUTE, 8) int32 tokens and lengths on ``dev`` as the
    brute tier's DP takes them."""
    import torch

    rng = random.Random(13)
    queries = []
    while len(queries) < N_BRUTE:
        w = words[rng.randrange(len(words))]
        k = 1 + len(queries) % 3
        j = rng.randrange(max(len(w) - k, 1))
        q = w[j : j + k]
        if engine._normalize_query(q)[1] == k:
            queries.append(q)
    qtok = torch.zeros((N_BRUTE, 8), dtype=torch.int32)
    qlens = torch.zeros(N_BRUTE, dtype=torch.int32)
    for i, q in enumerate(queries):
        qnorm, qlen = engine._normalize_query(q)
        qtok[i, :qlen] = torch.from_numpy(qnorm[:qlen].astype("int32"))
        qlens[i] = qlen
    return queries, qtok.to(dev), qlens.to(dev)


def _k5_ref_rows(args, rows: int = 4):
    """The plain version ``rows`` queries at a time (its (B, N, W + 1)
    working set stays a few GB on a 2M-term tier)."""
    import torch
    from stringsearchlib_tpu_torch.ops import dp_match as k5

    tokens, lengths, qtok, qlens = args
    return torch.cat([k5.dp_match_ref(tokens, lengths, qtok[i : i + rows], qlens[i : i + rows])
                      for i in range(0, qtok.shape[0], rows)])


def _brute_2d(engine, words, threshold, limit, dev):
    """16 queries of 1-3 characters on the 1M-row 2-D index: the brute tier,
    K5 over the whole 2M-term long tier.  Results equal the same queries
    recomputed with the plain DP; K5 on the long tier at B = 16 and B = 1
    bit-identical to the plain version, timed per call and in device time
    beside the bounds."""
    import torch
    from stringsearchlib_tpu_torch.ops import dp_match as k5

    queries, qtok, qlens = _brute_queries(engine, words, dev)
    engine.search_batch(queries[:2], threshold, limit)  # warm-up
    _reset_counts()
    t1 = time.perf_counter()
    got = engine.search_batch(queries, threshold, limit, batch_bucket=512)
    torch.cuda.synchronize()
    batch_ms = (time.perf_counter() - t1) * 1e3
    counts = _counts()
    if counts["k5"] <= 0 or counts["k5_plain"]:
        raise AssertionError(f"brute_2d counts {counts}")
    from stringsearchlib_tpu_torch.search import candidates, editdist
    from stringsearchlib_tpu_torch.search import engine as enginemod

    # the same search recomputed without K5
    with _bound_as((candidates, editdist, enginemod), "dp_match", k5.dp_match_ref):
        want = [engine.search_batch([q], threshold, limit)[0] for q in queries]
    _same_groups(got, want, "brute tier: K5 vs the plain DP")
    _check_results(got, queries, threshold * 0.4 * (1 - 1e-6), limit)
    di = engine.host.device
    long_args = (di.long_tokens, di.long_lengths)
    timing = {}
    for name, qa in (("k5_b16", (qtok, qlens)), ("k5_b1", (qtok[:1], qlens[:1]))):
        args = (*long_args, *qa)
        kd, pd = k5.dp_match(*args), _k5_ref_rows(args)
        torch.cuda.synchronize()
        if not torch.equal(kd, pd):
            raise AssertionError(f"K5 differs from its plain version on the long tier ({name})")
        del kd, pd
        bound, by, cell = _dp_bound(*args)
        timing[name] = {
            "ms": _cuda_ms(lambda: k5.dp_match(*args), 10),
            "device_ms": _queued_ms(lambda: k5.dp_match(*args), 10),
            "plain_ms": _cuda_ms(lambda: k5.dp_match_ref(*args), 1) if name == "k5_b1" else None,
            "bound_ms": bound, "bound_by": by, "dp_cell_bound_ms": cell,
            "plan": _k5_plan(args),
        }
        torch.cuda.empty_cache()
    return {
        "queries": queries, "counts": counts, "batch_ms": batch_ms,
        "long_tier_shape": list(di.long_tokens.shape),
        "mean_results": sum(len(k) for k, _ in got) / len(got),
        **timing,
    }


def _matmul_1m(threshold, limit, dev):
    """bench.py's dense_1m: 1M product names, whose dense (G, Tl) incidence
    fits GM_BUDGET: 512-query batches and 32 single queries take the
    gram-matrix route with the h* finish (torch._int_mm, as the reference
    leaves its product to XLA)."""
    import torch

    import bench
    from stringsearchlib_tpu_torch.config import IndexConfig
    from stringsearchlib_tpu_torch.index import build as buildmod
    from stringsearchlib_tpu_torch.search.engine import SearchEngine

    words = bench._product_names(N_1M)
    t1 = time.perf_counter()
    host = buildmod.build_index(words, 1, None, IndexConfig(), device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t1
    engine = SearchEngine(host)
    t1 = time.perf_counter()
    gm = host.gram_matrix(engine.GM_BUDGET)
    torch.cuda.synchronize()
    gm_s = time.perf_counter() - t1
    if gm is None:
        raise AssertionError("the 1M-key gram matrix is over GM_BUDGET")
    rng = random.Random(7)
    queries = [bench._mutate(rng, rng.choice(words)) for _ in range(N_QUERIES)]
    _reset_counts()
    (results, warm_s, rep_s), passes = _with_passes(
        engine, lambda: _timed_batches(engine, queries, threshold, limit)
    )
    singles = queries[:N_SINGLE_1M]
    got_single, s_routing = _spied(
        engine, singles, lambda q: engine.search(q, threshold, limit))
    counts = _counts()
    for rt in [passes[0][2]] + s_routing:
        if rt.get("variant") != "matmul" or not rt.get("hstar"):
            raise AssertionError(f"a dense_1m first pass routed {rt}")
    if any(counts[k] for k in counts if k.endswith("_plain")):
        raise AssertionError(f"matmul_1m counts {counts}")
    _check_results(results, queries, threshold, limit)
    _check_exact(engine, queries[:32], results[:32], threshold, limit)
    _same_groups(got_single, results[:N_SINGLE_1M], "matmul singles vs batch")
    _, single_ms = _single_ms(engine, singles, threshold, limit)
    med = sorted(rep_s)[len(rep_s) // 2]
    info = {
        "n_keys": len(words), "n_terms": host.n_terms, "n_grams": host.n_grams,
        "build_s": build_s, "gram_matrix_s": gm_s, "gram_matrix_shape": list(gm.shape),
        "qps_median": N_QUERIES / med, "rep_s": rep_s, "warmup_s": warm_s,
        "routing_first_pass": passes[0][2], "routing_single": s_routing[0],
        "counts": counts,
        "single_query_ms": {"n": len(singles), "p50": _pct(single_ms, 0.5),
                            "p90": _pct(single_ms, 0.9)},
        "mean_results": sum(len(k) for k, _ in results) / len(results),
        "traced_batch": _trace(lambda: engine.search_batch(
            queries, threshold, limit, batch_bucket=512)),
    }
    del gm
    return info, (host, engine, words, queries, results)


# the K1 probes: (id, file:line of the TPU kernel's pallas_call)
PROBES = (
    ("P1", "tools/probe_bandwidth.py:95"),
    ("P2", "tools/probe_layout_r5.py:128"),
    ("P3", "tools/probe_layout_r5.py:153"),
    ("P4", "tools/probe_layout_r5.py:226"),
    ("P5", "tools/probe_layout_r5.py:248"),
    ("P6", "tools/probe_layout_r5.py:277"),
    ("P7", "tools/probe_layout_r5.py:303"),
    ("P8", "tools/probe_kernel_raw.py:161"),
    ("P9", "tools/probe_kernel_bisect.py:192"),
)


def _probe_random(gen, dev) -> dict:
    """P1-P9 against their plain versions at small random and edge shapes:
    random signed tables and the every-bit-set (-1) and -128 tables; G = 37
    (a ragged row loop) and 2,816 for the streams; counts summing to 31 and
    to 127 (B = 33, a ragged last group of 16; 48 for P6) in both layouts,
    for P8/P9 with rows of -1 and -128 bytes under a query whose every count
    is its sum.  Returns {probe id: [cases, max_abs_err]}; raises on a
    difference."""
    import torch

    from stringsearchlib_tpu_torch.ops import bitmap_matmul as bmm
    from stringsearchlib_tpu_torch.ops import probes
    from stringsearchlib_tpu_torch.tools import common

    res = {p: [0, 0] for p, _ in PROBES}

    def check(probe, got, want, what):
        torch.cuda.synchronize()
        err = common.max_abs_err(got, want)
        res[probe][0] += 1
        res[probe][1] = max(res[probe][1], err)
        if err or got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(f"{probe} differs from its plain version on {what}: {err}")

    def table(g, kind):
        if kind == "random":
            return torch.randint(-128, 128, (g, 3 * 512), generator=gen,
                                 dtype=torch.int8).to(dev)
        return torch.full((g, 3 * 512), -1 if kind == "ones" else -128,
                          dtype=torch.int8, device=dev)

    def counts(b, gp, total):
        return _random_case(gen, b, gp, 1, total, "cpu")[1].to(dev)

    for g in (37, 2816):
        for kind in ("random", "ones", "min"):
            t = table(g, kind)
            t3 = bmm.to_tile_major(t)
            r = torch.randint(-130, 10, (1, 512), generator=gen, dtype=torch.int32).to(dev)
            what = f"g={g} {kind}"
            check("P1", probes.pl_stream(t), probes.stream_ref(t), what)
            check("P2", probes.stream_row(t, r), probes.stream_ref(t, r), what)
            check("P3", probes.stream_tile(t3, r), probes.stream_ref(t3, r), what)
    for total in (31, 127):
        for kind in ("random", "ones", "min"):
            gp = 2816 if kind == "random" else 128
            t = table(gp, kind)
            t3 = bmm.to_tile_major(t)
            for variant in probes.PAIR_VARIANTS:
                q = counts(48 if variant == "tile_q2" else 33, gp, total)
                tv = t if variant == "row" else t3
                check(probes.PAIR_PROBE[variant],
                      probes.pair(q, tv, variant=variant),
                      probes.pair_ref(q, tv, variant=variant), f"sum={total} {kind}")
        t = table(2816, "random")
        t[:4], t[4:8] = -1, -128
        q = counts(33, 2816, total)
        q[0] = 0
        q[0, 0], q[0, 4] = total - 2, 2
        for tv in (t, bmm.to_tile_major(t)):
            what = f"sum={total} {'row' if tv.ndim == 2 else 'tile'}-major"
            for i16 in (True, False):
                check("P8", probes.raw_hits(q, tv, i16=i16),
                      probes.raw_hits_ref(q, tv, i16=i16), what)
            for variant in probes.BISECT_VARIANTS:
                check("P9", probes.bisect_run(q, tv, variant=variant),
                      probes.bisect_ref(q, tv, variant=variant), f"{what} {variant}")
    return res


def _probe_phase(table, slots, dev) -> dict:
    """The probe tools' cases at full shape (``tools.probe_*``): P1, P8 at
    B = 256 and 512 and P9's variants on ``table`` in the reference's
    row-major layout with the first 256 queries' counts (the tools' queries),
    P2-P7 on the tools' synthetic 2,560-tile table in both layouts.  Every
    count is set to 0, each case driven once and the counts read; then each
    case is held against its plain version and timed (``common.measure``),
    and the layout tool's own parity is checked."""
    import torch

    from stringsearchlib_tpu_torch.ops import bitmap_matmul as bmm
    from stringsearchlib_tpu_torch.ops import probes
    from stringsearchlib_tpu_torch.tools import (
        common, probe_bandwidth, probe_kernel_bisect, probe_kernel_raw, probe_layout,
    )

    rm = bmm.from_tile_major(table).contiguous()
    q = common.counts(slots[:256], int(table.shape[1]), dev)
    q2 = torch.cat([q, q])
    t_row, t_tile = probe_layout.synthetic_tables(2560, probe_layout.GP, dev)
    qs = probe_layout.synthetic_queries(512, probe_layout.GP, dev)
    cases = (probe_layout.cases(t_row, t_tile, qs, 256)
             + [probe_bandwidth.p1_case(rm), probe_kernel_raw.raw_case(q, rm),
                probe_kernel_raw.raw_case(q2, rm, "raw_hits_i16_b512")]
             + probe_kernel_bisect.bisect_cases(q, rm))
    torch.cuda.synchronize()
    _reset_counts()
    for case in cases:
        case.kernel()
    torch.cuda.synchronize()
    launches, plain = dict(probes.LAUNCHES), dict(probes.REF_CALLS)
    if any(n <= 0 for n in launches.values()) or any(plain.values()):
        raise AssertionError(f"probe launches {launches}, plain calls {plain}")
    results = []
    for case in cases:
        results.append(common.measure(case))
        print(json.dumps({"probe_case": results[-1]}), flush=True)
    parity = probe_layout.parity(t_row, t_tile, qs, 256)
    if not all(parity.values()):
        raise AssertionError(f"pair variants differ from pair_row: {parity}")
    max_windows = int(q.sum(1).max())
    del rm, q, q2, t_row, t_tile, qs, cases
    torch.cuda.empty_cache()
    return {"launches": launches, "results": results, "layout_parity": parity,
            "max_windows": max_windows}


def _probe_entry(probe: str, line: str, run: dict, edges: dict, ptxas: dict) -> dict:
    """One probe's entry of the kernels line: its first full-shape case's
    numbers, every case of it under ``cases``."""
    mine = [r for r in run["results"] if r["probe"] == probe]
    first = mine[0]
    return {
        "name": f"{probe} {first['name']}",
        "route": "cuda",
        "source": "stringsearchlib_tpu_torch/csrc/"
                  + ("probe_stream.cu" if probe in ("P1", "P2", "P3") else "probe_hits.cu"),
        "replaces": line,
        "launches": run["launches"][probe],
        "max_abs_err": max([edges[probe][1]] + [r["max_abs_err"] for r in mine]),
        **{k: first[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "gb_per_s")},
        "cases": {r["name"]: {k: r[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                                "bound_by", "gb_per_s", "compared_rows")}
                  for r in mine},
        "edge_cases": edges[probe][0],
        **({"ptxas": ptxas["stream"]} if probe in ("P1", "P2", "P3") else {}),
    }


N_LONG_2D = 256  # > 127-window queries on the 2-D index (phase 22)
N_LONG_DENSE = 32
N_LONG_ORACLE = 8
N_CAPI = 64
N_CABI = 32


def _words_2d(n2: int) -> list:
    """bench.py's index2d_1m_rows corpus: (product name, gram-rich
    description) rows, flattened."""
    import bench

    rows = bench._product_names(n2, seed=5)
    descs = bench._rich_names(n2, seed=6)
    return [x for kv in zip(rows, descs) for x in kv]


def _long_queries_2d(words2, n: int) -> list:
    """Queries of more than 127 gram windows (random.Random(13)): two or
    more mutated name + description pairs joined by spaces, at least 140
    and at most 250 characters (one 256-wide query group)."""
    import bench

    rng = random.Random(13)
    half = len(words2) // 2
    out = []
    while len(out) < n:
        parts: list = []
        while len(parts) < 4 or len(" ".join(parts)) < 140:
            r = rng.randrange(half)
            parts += [bench._mutate(rng, words2[2 * r]), bench._mutate(rng, words2[2 * r + 1])]
        out.append(" ".join(parts)[:250])
    return out


def _oracle_child(conn, n2: int, n_long: int, n_oracle: int, threshold: float) -> None:
    """The port's pure-Python oracle over the 2-D corpus, in a process of
    its own: it rebuilds the corpus and the long queries from their seeds
    and sends back, for the first ``n_oracle`` of them, every result above
    ``threshold`` (unbounded)."""
    from stringsearchlib_tpu_torch.utils.oracle import OracleIndex

    try:
        words2 = _words_2d(n2)
        queries = _long_queries_2d(words2, n_long)[:n_oracle]
        t0 = time.perf_counter()
        oracle = OracleIndex(words2, row_size=2, weights=[1.0, 0.4] * n2)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        results = [oracle.search(q, threshold, 0) for q in queries]
        conn.send({"queries": queries, "results": results, "build_s": build_s,
                   "search_s": time.perf_counter() - t0})
    except BaseException as e:  # reported to the parent, which raises
        conn.send({"error": repr(e)})
    finally:
        conn.close()


def _oracle_rows(words, queries, threshold: float, chunk: int = 1 << 20):
    """Indices of the rows of a one-column corpus that can score on any of
    ``queries``: every term too short for the gram tier, and every long term
    whose gram hits reach ``threshold`` times its query's gram count (the
    gram tier's pass rule, float32 as the oracle computes it).  A row
    outside can reach no result of those queries, so the oracle over the
    rows inside answers them as over the whole corpus.  Vectorized over the
    port's numpy text and gram layers (not the index build)."""
    import numpy as np

    from stringsearchlib_tpu_torch.core import grams as gramlib
    from stringsearchlib_tpu_torch.core import text as textlib

    g = 3
    tables = textlib.TextTables()

    def gram_rows(strings):
        tok, ln = textlib.encode_batch(strings, False)
        nt, nl = textlib.normalize_matrix(tok, ln, tables)
        ids, valid = gramlib.gram_ids(nt, nl, g, False)
        return nl, np.where(valid, ids, -1)

    q_len, q_ids = gram_rows(queries)
    union = np.unique(q_ids[q_ids >= 0])
    # (grams of any query, queries) multiplicities
    mult = np.zeros((union.size, len(queries)), np.float32)
    for qi in range(len(queries)):
        grams, m = np.unique(q_ids[qi][q_ids[qi] >= 0], return_counts=True)
        mult[np.searchsorted(union, grams), qi] = m
    n_q = np.maximum(q_len.astype(np.int64) - g + 1, 1).astype(np.float32)
    thr = np.float32(threshold)
    keep = []
    for lo in range(0, len(words), chunk):
        w_len, w_ids = gram_rows(words[lo : lo + chunk])
        pos = np.searchsorted(union, w_ids).clip(max=max(union.size - 1, 0))
        hit = (w_ids >= 0) & (union[pos] == w_ids) if union.size else w_ids < -1
        present = np.zeros((w_ids.shape[0], max(union.size, 1)), np.float32)
        r, c = np.nonzero(hit)
        present[r, pos[r, c]] = 1.0  # each gram once per term, as a set
        hits = present @ mult  # exact: small integer counts in float32
        ok = (hits > 0) & (hits / n_q[None, :] >= thr)
        keep.append(lo + np.flatnonzero(ok.any(axis=1) | (w_len < 2 * g)))
    return np.concatenate(keep)


def _oracle_child_10m(conn, n_keys: int, n_oracle: int, threshold: float) -> None:
    """The port's pure-Python oracle over the headline corpus, in a process
    of its own: it rebuilds the corpus and phase 4's queries from their
    seeds and sends back, for the first ``n_oracle`` of them, every result
    above ``threshold`` (unbounded).  The oracle indexes the rows that can
    score on those queries (``_oracle_rows``): over all 10M rows its build
    alone outlasts the run."""
    import bench
    from stringsearchlib_tpu_torch.utils.oracle import OracleIndex

    try:
        words = bench._product_names(n_keys, seed=2)
        rng = random.Random(7)
        queries = [bench._mutate(rng, rng.choice(words)) for _ in range(N_QUERIES)]
        t0 = time.perf_counter()
        rows = _oracle_rows(words, queries[:n_oracle], threshold)
        filter_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        oracle = OracleIndex([words[i] for i in rows], row_size=1)
        del words
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        results = [oracle.search(q, threshold, 0) for q in queries[:n_oracle]]
        conn.send({"queries": queries[:n_oracle], "results": results,
                   "rows": int(rows.size), "filter_s": filter_s,
                   "build_s": build_s, "search_s": time.perf_counter() - t0})
    except BaseException as e:  # reported to the parent, which raises
        conn.send({"error": repr(e)})
    finally:
        conn.close()


class _OracleJob:
    """``target`` (``_oracle_child`` or ``_oracle_child_10m``) started in a
    spawned process (no CUDA there), running beside the card's phases until
    its answers are read."""

    def __init__(self, target, *args):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self.conn, child = ctx.Pipe(duplex=False)
        self.proc = ctx.Process(target=target, args=(child, *args), daemon=True)
        self.proc.start()
        child.close()
        self.waited_s = None

    def result(self) -> dict:
        t0 = time.perf_counter()
        try:
            out = self.conn.recv()
        except EOFError:
            self.proc.join(60)
            raise AssertionError(
                f"the oracle process ended without an answer (exit code "
                f"{self.proc.exitcode})") from None
        self.waited_s = time.perf_counter() - t0
        self.proc.join(60)
        if "error" in out:
            raise AssertionError(f"the oracle process failed: {out['error']}")
        return out

    def stop(self) -> None:
        if self.proc.is_alive():
            self.proc.terminate()
        self.proc.join(60)


def _oracle_agrees(got, want_all, limit: int, what: str) -> None:
    """``got`` (keys, scores) at ``limit`` against the oracle's unbounded
    (keys, scores): the same (score, key length) tie groups over the
    oracle's first ``limit`` results, with the same keys; in the last group,
    which the limit may cut, the engine's keys among the oracle's whole
    group."""
    keys_w, sc_w = want_all
    n = min(limit, len(keys_w))
    if len(got[0]) != n:
        raise AssertionError(f"{what}: {len(got[0])} results, the oracle {n}")
    if n == 0:
        return

    def group(keys, scores):
        out: dict = {}
        for k, v in zip(keys, scores):
            out.setdefault((round(float(v), 5), len(k)), set()).add(k)
        return out

    gg, gw = group(*got), group(keys_w[:n], sc_w[:n])
    last = (round(float(sc_w[n - 1]), 5), len(keys_w[n - 1]))
    if set(gg) != set(gw):
        raise AssertionError(f"{what}: tie groups differ from the oracle's")
    for key, keys in gg.items():
        if key != last and keys != gw[key]:
            raise AssertionError(f"{what}: keys of group {key} differ from the oracle's")
    full = group(keys_w, sc_w)[last]
    if len(gg[last]) != len(gw[last]) or not gg[last] <= full:
        raise AssertionError(f"{what}: the last tie group is not the oracle's")


def _int_mm_bound(b: int, d: int, tlp: int):
    """One (B, D) x (D, Tlp) int8 product: the incidence read once and the
    int32 product written once, against two int8 operations per term."""
    return _bound(d * tlp + 4 * b * tlp, 2.0 * b * d * tlp, PEAK_INT8)


def _sketch_unpacked(engine2, queries2, results2, words2, threshold, limit, dev,
                     oracle_job) -> dict:
    """Phase 22: the unpacked sketch on the resident 2-D index.  (a) phase
    8's queries with SKETCH_PACKED off: every pass ``sketch``, no K2, the
    results phase 8's packed-sketch results; (b) queries of more than 127
    gram windows with the defaults: every pass ``sketch`` with int32 counts
    (two ``torch._int_mm`` digits), the results the dense path's on the
    first 32, the oracle's on 8.  The product held against a float32 one
    (exact below 2^24) and timed beside its bound."""
    import torch

    from stringsearchlib_tpu_torch.search import candidates as pcand
    from stringsearchlib_tpu_torch.search import sketch as psk

    host2 = engine2.host
    t1 = time.perf_counter()
    sku = host2.sketch_tables(engine2.SKETCH_BUDGET, packed=False)
    torch.cuda.synchronize()
    table_s = time.perf_counter() - t1
    if sku is None:
        raise AssertionError("no unpacked sketch table for the 2-D index")
    inc_u, tg_u, _, d_log2_u = sku
    d, tlp = int(inc_u.shape[0]), int(inc_u.shape[1])
    out = {"table": {"d": d, "d_log2": d_log2_u, "tl_pad": tlp,
                     "inc_bytes": int(inc_u.numel()), "inc_shape": list(inc_u.shape),
                     "column_major": inc_u.stride() == (1, d), "build_s": table_s}}

    def run_checked(queries, what):
        """One batch with every candidate pass and every query group's
        guard outcome recorded: (results, what they show)."""
        _reset_counts()
        pcand.INT_MM_CALLS = 0
        groups = []
        orig = engine2._run_candidate_chunks

        def spy(items, *a):
            left = orig(items, *a)
            groups.append((len(items), len(left), dict(engine2.last_routing)))
            return left

        engine2._run_candidate_chunks = spy
        try:
            res, passes = _with_passes(engine2, lambda: engine2.search_batch(
                queries, threshold, limit, batch_bucket=512))
            torch.cuda.synchronize()
        finally:
            del engine2._run_candidate_chunks
        counts, mm = _counts(), pcand.INT_MM_CALLS
        variants = sorted({p[2]["variant"] for p in passes})
        if variants != ["sketch"] or mm <= 0 or counts["k2"] or counts["k2_plain"]:
            raise AssertionError(f"{what}: variants {variants}, _int_mm calls {mm}, {counts}")
        _check_results(res, queries, threshold * 0.4 * (1 - 1e-6), limit)
        return res, {
            "passes": len(passes), "variants": variants,
            "int_mm_calls_per_batch": mm, "counts": counts,
            # rows the guard passed on the sketch, and rows it sent dense
            "candidate_rows": sum(g[0] for g in groups),
            "dense_rows": sum(g[1] for g in groups),
            "retry_fast": sum(g[2].get("retry_fast", 0) for g in groups),
            "retry_full": sum(g[2].get("retry_full", 0) for g in groups),
            "steps": sorted({p[2]["step"] for p in passes}),
        }

    # (a) phase 8's queries through the unpacked sketch
    engine2.SKETCH_PACKED = False
    try:
        res_a, info_a = run_checked(queries2, "unpacked sketch, phase 8's queries")
        _same_groups(res_a, results2, "unpacked against packed sketch")
        _, _, rep_a = _timed_batches(engine2, queries2, threshold, limit)
        trace_a = _trace(lambda: engine2.search_batch(
            queries2, threshold, limit, batch_bucket=512))
    finally:
        engine2.SKETCH_PACKED = True
    info_a.update(qps_median=len(queries2) / sorted(rep_a)[1], rep_s=rep_a,
                  n_queries=len(queries2), traced_batch=trace_a)
    out["phase8_queries"] = info_a

    # (b) queries of more than 127 windows, with the defaults
    long_q = _long_queries_2d(words2, N_LONG_2D)
    items = []
    for pos, q in enumerate(long_q):
        qnorm, qlen = engine2._normalize_query(q)
        items.append((pos, qnorm, qlen, None))
    _, _, _, slots, _, _, _ = engine2._prep_rows(items, 256)
    if slots.shape[1] <= 127:
        raise AssertionError(f"long queries hold {slots.shape[1]} windows")
    res_b, info_b = run_checked(long_q, "unpacked sketch, long queries")
    if info_b["candidate_rows"] != N_LONG_2D:
        raise AssertionError(f"long queries on the sketch route: {info_b}")
    _, _, rep_b = _timed_batches(engine2, long_q, threshold, limit)
    trace_b = _trace(lambda: engine2.search_batch(long_q, threshold, limit, batch_bucket=512))
    _check_exact(engine2, long_q[:N_LONG_DENSE], res_b[:N_LONG_DENSE], threshold, limit)
    oracle = oracle_job.result()
    if oracle["queries"] != long_q[:N_LONG_ORACLE]:
        raise AssertionError("the oracle process drew other queries")
    for i, want in enumerate(oracle["results"]):
        _oracle_agrees(res_b[i], want, limit, f"long query {i}")
    info_b.update(
        qps_median=N_LONG_2D / sorted(rep_b)[1], rep_s=rep_b, n_queries=N_LONG_2D,
        traced_batch=trace_b,
        windows=int(slots.shape[1]), dense_checked=N_LONG_DENSE,
        oracle_checked=N_LONG_ORACLE, oracle_build_s=oracle["build_s"],
        oracle_search_s=oracle["search_s"], oracle_wait_s=oracle_job.waited_s,
    )
    out["long_queries"] = info_b

    # the product on the card against a float32 product, and timed
    qs = torch.from_numpy(np_tile(slots, 256)).to(dev)
    qcnt = psk.query_counts(psk.bucket_of(qs, d_log2_u), d)
    hits = psk.unpacked_hits(qcnt, inc_u, int(slots.shape[1]))
    if hits.dtype != torch.int32:
        raise AssertionError(f"long queries' hits are {hits.dtype}")
    err = 0
    for a in range(0, tlp, 1 << 16):
        want = (qcnt.float() @ inc_u[:, a : a + (1 << 16)].float()).to(torch.int32)
        err = max(err, _max_abs_err(hits[:, a : a + (1 << 16)], want))
    if err:
        raise AssertionError(f"the unpacked product differs from float32: {err}")
    del hits
    digit = (qcnt % 128).to(torch.int8)
    # the same product on a row-major copy of the table, in turns
    inc_rm = inc_u.contiguous()
    product = {}
    for name, q8 in (("b256", digit), ("b512", torch.cat([digit, digit]))):
        b = int(q8.shape[0])
        bound = _int_mm_bound(b, d, tlp)
        product[name] = {
            "ms": _cuda_ms(lambda: torch._int_mm(q8, inc_u), 5),
            "device_ms": _queued_ms(lambda: torch._int_mm(q8, inc_u), 5),
            "row_major_ms": _cuda_ms(lambda: torch._int_mm(q8, inc_rm), 5),
            "row_major_device_ms": _queued_ms(lambda: torch._int_mm(q8, inc_rm), 5),
            "bound_ms": bound[0], "bound_by": bound[1], "b": b, "d": d, "tl_pad": tlp,
        }
    del inc_rm
    product["unpacked_hits_b256_two_digits"] = {
        "ms": _cuda_ms(lambda: psk.unpacked_hits(qcnt, inc_u, int(slots.shape[1])), 3),
        "device_ms": _queued_ms(
            lambda: psk.unpacked_hits(qcnt, inc_u, int(slots.shape[1])), 3),
    }
    torch.cuda.empty_cache()
    out["int_mm"] = product
    out["max_abs_err"] = err
    return out


def _persistence_api(idx, queries, results, routing, build_s, threshold, limit) -> dict:
    """Phase 23, on the resident 10M-key index: ``StringSearchIndex.save``,
    ``StringSearchIndex.load`` on the card (arrays held equal), phase 4's
    batch through the loaded engine (the same routing and results, K1
    launched), ``capi.loadIndex``, single queries through ``capi.score``
    with ``QueryMetrics``, and queries through ``cabi.function_table()``
    called as C function pointers."""
    import ctypes as ct
    import shutil
    import tempfile

    import torch

    from stringsearchlib_tpu_torch import StringSearchIndex
    from stringsearchlib_tpu_torch.api import cabi, capi
    from stringsearchlib_tpu_torch.index.arrays import FIELDS
    from stringsearchlib_tpu_torch.utils import metrics

    os.makedirs(os.path.join(_ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="persist_", dir=os.path.join(_ROOT, "build"))
    path = os.path.join(tmp, "index.npz")
    handle = None
    try:
        t1 = time.perf_counter()
        idx.save(path)
        save_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        loaded = StringSearchIndex.load(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t1
        for f in FIELDS:
            a, b = getattr(loaded.host.device, f), getattr(idx.host.device, f)
            if a.device != b.device or not torch.equal(a, b):
                raise AssertionError(f"loaded index: {f} differs")
        _reset_counts()
        res_l, warm_s, rep_s = _timed_batches(loaded.engine, queries, threshold, limit)
        counts = _counts()
        if loaded.engine.last_routing != routing:
            raise AssertionError(
                f"loaded index routed {loaded.engine.last_routing}, built {routing}")
        if counts["k1"] <= 0 or counts["k1_plain"]:
            raise AssertionError(f"loaded index: {counts}")
        _same_groups(res_l, results, "loaded against built index")

        def batch_s(engine):
            t = time.perf_counter()
            engine.search_batch(queries, threshold, limit, batch_bucket=512)
            torch.cuda.synchronize()
            return time.perf_counter() - t

        # batch seconds in turns (built, loaded, loaded, built), three rounds
        turns = {"built": [], "loaded": []}
        for _ in range(3):
            for k, v in _in_turns({"built": idx.engine, "loaded": loaded.engine},
                                  batch_s).items():
                turns[k] += v
        stats = metrics.index_stats(loaded.host)
        del loaded, res_l
        torch.cuda.empty_cache()

        t1 = time.perf_counter()
        handle = capi.loadIndex(path)
        torch.cuda.synchronize()
        capi_load_s = time.perf_counter() - t1
        entry = capi.GLOBAL_REGISTRY.get(handle)
        entry.engine.metrics = qm = metrics.QueryMetrics()
        for i, q in enumerate(queries[:N_CAPI]):
            if _tie_groups(*capi.score(handle, q, threshold, limit)) != _tie_groups(*results[i]):
                raise AssertionError(f"capi.score differs from the batch on query {i}")
        snapshot = qm.snapshot()
        if snapshot["queries"] != N_CAPI:
            raise AssertionError(f"QueryMetrics counted {snapshot}")

        tbl = cabi.function_table()
        fn = {name: ct.cast(addr, type(f)) for name, (f, addr) in tbl.items()}
        res_p, sc_p = ct.POINTER(ct.c_char_p)(), ct.POINTER(ct.c_float)()
        t1 = time.perf_counter()
        for i, q in enumerate(queries[N_CAPI : N_CAPI + N_CABI], N_CAPI):
            n = fn["score"](handle, q.encode("latin-1"), ct.byref(res_p), ct.byref(sc_p),
                            ct.c_float(threshold), limit)
            got = ([res_p[j].decode("latin-1") for j in range(n)], [sc_p[j] for j in range(n)])
            if res_p[n] is not None or _tie_groups(*got) != _tie_groups(*results[i]):
                raise AssertionError(f"cabi score differs from the batch on query {i}")
            fn["release"](handle, res_p, sc_p)
            if fn["search"](handle, q.encode("latin-1"), ct.byref(res_p),
                            ct.c_float(threshold), limit) != n:
                raise AssertionError(f"cabi search counted otherwise on query {i}")
            fn["release"](handle, res_p, None)
        cabi_s = time.perf_counter() - t1
        sizes = (fn["getSize"](handle), fn["getLibSize"](handle))
        if sizes != (idx.size(), idx.lib_size()):
            raise AssertionError(f"cabi sizes {sizes}")
        fn["dispose"](handle)
        if capi.getSize(handle):
            raise AssertionError("cabi dispose left the index")
        handle = None
        return {
            "save_s": save_s, "load_s": load_s, "capi_load_s": capi_load_s,
            "build_s": build_s, "file_bytes": os.path.getsize(path),
            "loaded_qps_median": len(queries) / sorted(rep_s)[1], "rep_s": rep_s,
            "warmup_s": warm_s, "in_turns_batch_s": turns,
            "in_turns_qps_median": {k: len(queries) / sorted(v)[len(v) // 2]
                                    for k, v in turns.items()}, "loaded_counts": counts, "capi_queries": N_CAPI,
            "query_metrics": snapshot, "cabi_queries": N_CABI,
            "cabi_ms_per_query": cabi_s / N_CABI * 1e3, "index_stats": stats,
        }
    finally:
        if handle is not None:
            capi.dispose(handle)
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()


N_ORACLE_10M = 8  # phase 24's queries held against the oracle
N_RESHARD = 64  # phase 24's queries at S = 4
N_TP = 256  # phase 25's batch queries
N_TP_HITS = 8  # phase 25's queries whose summed hits are held bit for bit
N_MH = 256  # phase 26's queries


def _sharded_counts() -> dict:
    """The launch counts a sharded path reads: K5, K6's expansion, their
    plain calls, and ``torch._int_mm`` calls (a library product)."""
    from stringsearchlib_tpu_torch.search import candidates as pc

    c = _counts()
    return {"k5": c["k5"], "k5_plain": c["k5_plain"], "expand": c["expand"],
            "k6": c["k6"], "k6_plain": c["k6_plain"], "int_mm": pc.INT_MM_CALLS}


def _reset_sharded_counts() -> None:
    from stringsearchlib_tpu_torch.search import candidates as pc

    _reset_counts()
    pc.INT_MM_CALLS = 0


def _shard_placement(engine) -> dict:
    """Bytes the sharded engine holds on the card: each shard's own
    tensors (its slices and gram matrix), and the replicated leaves."""
    from stringsearchlib_tpu_torch.parallel import dist

    shards = engine._leaves()
    own = [sum(t.numel() * t.element_size() for n, t in lv.items() if n in dist._STACKED)
           for lv in shards]
    rep = {id(t): t.numel() * t.element_size() for lv in shards
           for n, t in lv.items() if n not in dist._STACKED}
    return {"per_shard_bytes": own, "replicated_bytes": sum(rep.values())}


def _shard_step_times(engine, rt, queries, threshold, limit) -> dict:
    """CUDA-event milliseconds of one shard's candidate pass and of the
    merge, on the first chunk of a batch at the step of routing ``rt`` (a
    first pass), with the operands the engine hands them."""
    import numpy as np

    from stringsearchlib_tpu_torch.parallel import dist
    from stringsearchlib_tpu_torch.search.engine import _next_pow2

    step = int(rt["step"])
    items = []
    for pos, q in enumerate(queries[:step]):
        qn, ql = engine._normalize_query(q)
        items.append((pos, qn, ql, engine.host.promo_key_ids(qn, ql)[: engine.PROMO_KEYS]))
    b, qtok, qlens, slots, nqg, use_short, s_cap = engine._prep_rows(items, 32)
    promo = np.full((b, engine.PROMO_KEYS), -1, np.int32)
    for r, it in enumerate(items):
        promo[r, : it[3].size] = it[3]
    promo_t, promo_w = engine._promo_tables_sharded(promo)
    shards = engine._leaves()
    dev = engine.mesh.device
    qbuf = dist.replicate((qtok, qlens, slots, nqg, use_short, promo,
                           np.full(b, limit, np.int32)), [dev])[dev]
    top_k = _next_pow2(limit, 16)
    kw = dict(front=rt["variant"], compute_short=bool(use_short.any()) and engine.sx.ts_c > 0,
              s_cap=s_cap, n_cand=int(rt["n_cand"]), n_edge=min(max(_next_pow2(max(
                  int(engine.sx.leaves["extra_key"].shape[1]), 1), 16), 16), engine.CAND_EDGES),
              top_k=top_k, block_sel=bool(rt["block_sel"]))
    thr = np.float32(threshold)
    p_t = [dist.upload(promo_t[i], dev) for i in engine.mesh.shard_ids]
    p_w = [dist.upload(promo_w[i], dev) for i in engine.mesh.shard_ids]
    outs = [dist.shard_candidates(lv, qbuf, p_t[i], p_w[i], thr, **kw)
            for i, lv in enumerate(shards)]
    k_total = int(shards[0]["key_len"].shape[0])
    return {
        "b": b, "s_cap": s_cap,
        "shard_step_ms": _cuda_ms(
            lambda: dist.shard_candidates(shards[0], qbuf, p_t[0], p_w[0], thr, **kw), 3),
        "merge_ms": _cuda_ms(
            lambda: dist.merge_candidates(engine.mesh, outs, k_total, limit, top_k), 5),
        "steps_per_batch": engine.sx.n_shards * -(-N_QUERIES // step),
    }


def _sharded_10m(host, engine, words, queries, results, threshold, limit, dev):
    """Phase 24: the term-sharded engine at 10M keys on the resident
    headline index.  ``shard_index(host, 8)`` (read to host numpy), a
    ShardedEngine on eight shards of the one card: the headline's 512
    queries (every first pass ``matmul``, ``torch._int_mm`` per shard),
    equal to phase 4's results (the first 8 go to the port's oracle at the
    end of the run, ``_sharded_oracle``); then the elastic re-shard at S = 4 (``runs``: K6's expansion per
    shard): 64 of the queries equal to S = 8's, 16 queries of 1-3
    characters (K5 per shard) and the wildcard equal to the single
    engine's.  Counts are set to 0 before each driven run and read after."""
    import torch

    from stringsearchlib_tpu_torch.parallel import dist
    from stringsearchlib_tpu_torch.search.engine import _next_pow2
    from stringsearchlib_tpu_torch.utils.capacity import (
        device_hbm_bytes, estimate_shard_hbm,
    )

    out = {"n_keys": len(words)}
    avg_len = round(sum(len(w) for w in words[:100_000]) / min(len(words), 100_000))
    for s in (8, 4):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sx = dist.shard_index(host, s)
        shard_s = time.perf_counter() - t1
        mem0 = torch.cuda.memory_allocated()
        t1 = time.perf_counter()
        eng = dist.ShardedEngine(sx, dist.make_mesh(s, device=dev))
        gm = eng._gram_matrix_stacked()
        torch.cuda.synchronize()
        place_s = time.perf_counter() - t1
        placed = _shard_placement(eng)
        plan = estimate_shard_hbm(len(words), shards=s, avg_len=avg_len,
                                  n_grams=host.n_grams, batch=512,
                                  top_k=_next_pow2(limit, 16))
        info = {
            "shard_index_s": shard_s, "place_s": place_s,
            "memory_allocated_delta_bytes": torch.cuda.memory_allocated() - mem0,
            **placed, "gram_matrix": gm is not None,
            "plan_bytes": {"resident": plan.resident, "total": plan.total,
                           "breakdown_gb": plan.breakdown()},
            "tl_c": sx.tl_c, "ts_c": sx.ts_c,
            "posting_mass_per_shard": sx.host_shard_posting_lens.sum(axis=1).tolist(),
        }
        del sx
        qs = queries if s == 8 else queries[:N_RESHARD]
        _reset_sharded_counts()
        (res, warm_s, rep_s), passes = _with_passes(
            eng, lambda: _timed_batches(eng, qs, threshold, limit))
        torch.cuda.synchronize()
        counts = _sharded_counts()
        first = passes[0][2]
        # the front the budget rule picks: G * Tl_c within GM_BUDGET
        want = "matmul" if gm is not None else "runs"
        if any(p[2]["variant"] != want for p in passes):
            raise AssertionError(f"S = {s}: passes routed {[p[2] for p in passes]}, not {want}")
        if counts["k5_plain"] or counts["k6_plain"]:
            raise AssertionError(f"S = {s}: plain calls {counts}")
        if want == "matmul" and counts["int_mm"] <= 0:
            raise AssertionError(f"S = {s}: no torch._int_mm call {counts}")
        if want == "runs" and counts["expand"] < s:
            raise AssertionError(f"S = {s}: K6's expansion launched {counts['expand']} times")
        _check_results(res, qs, threshold, limit)
        if s == 8:
            _same_groups(res, results, "sharded S = 8 vs phase 4")
            res8 = res
            info["step_times"] = _shard_step_times(eng, first, qs, threshold, limit)
        else:
            _same_groups(res, res8[:N_RESHARD], "sharded S = 4 vs S = 8")
            brute_q = _brute_queries(engine, words, dev)[0]
            _reset_sharded_counts()
            got_b = eng.search_batch(brute_q + ["*"], threshold, limit)
            torch.cuda.synchronize()
            info["brute_counts"] = _sharded_counts()
            if info["brute_counts"]["k5"] <= 0 or info["brute_counts"]["k5_plain"]:
                raise AssertionError(f"S = 4 brute tier: {info['brute_counts']}")
            want_b = engine.search_batch(brute_q, threshold, limit)
            want_b.append(engine.search("*", threshold, limit))
            _same_groups(got_b, want_b, "sharded S = 4 brute + wildcard vs the single engine")
            info["brute_mean_results"] = sum(len(k) for k, _ in got_b) / len(got_b)
        med = sorted(rep_s)[len(rep_s) // 2]
        info.update({
            "n_queries": len(qs), "qps_median": len(qs) / med, "rep_s": rep_s,
            "warmup_s": warm_s, "routing_first_pass": first,
            "passes": [p[2] for p in passes], "counts": counts,
            "mean_results": sum(len(k) for k, _ in res) / len(res),
        })
        out[f"s{s}"] = info
        del eng, gm
        torch.cuda.empty_cache()
    out["card_bytes"] = device_hbm_bytes(dev)
    return out, res8[:N_ORACLE_10M]


def _sharded_oracle(got, queries, limit, oracle_10m) -> dict:
    """Phase 24's first results at S = 8 against the port's oracle over the
    headline corpus, read at the end of the run: the oracle's build takes
    most of the run in its own process."""
    oracle = oracle_10m.result()
    if oracle["queries"] != queries[:N_ORACLE_10M]:
        raise AssertionError("the oracle's queries are not phase 4's")
    for i, (g, want) in enumerate(zip(got, oracle["results"])):
        _oracle_agrees(g, want, limit, f"sharded S = 8 query {i} vs the oracle")
    return {"n": len(got), "rows": oracle["rows"], "filter_s": oracle["filter_s"],
            "build_s": oracle["build_s"], "search_s": oracle["search_s"],
            "wait_s": oracle_10m.waited_s}


def _tp_dp_1m(host, engine, words, queries, results, threshold, limit, dev) -> dict:
    """Phase 25: the gram-sharded engine (``shard_index_by_grams(host, 4)``)
    and the DP x TP engine (``shard_index_2d(host, 2, 2)``) on dense_1m's
    resident index, each on one card: 256 of phase 20's queries and 16 of
    1-3 characters, equal to the single engine's; the summed TP hits of 8
    queries bit-identical to ``gather_hits`` on the whole index."""
    import numpy as np
    import torch

    from stringsearchlib_tpu_torch.parallel import dp_tp, tp
    from stringsearchlib_tpu_torch.parallel.dist import make_mesh, replicate
    from stringsearchlib_tpu_torch.search.engine import _next_pow2
    from stringsearchlib_tpu_torch.search.overlap import gather_hits

    qs = queries[:N_TP]
    want = results[:N_TP]
    brute_q = _brute_queries(engine, words, dev)[0]
    want_b = engine.search_batch(brute_q, threshold, limit)
    out = {}
    for name in ("tp", "dp_tp"):
        t1 = time.perf_counter()
        if name == "tp":
            ix = tp.shard_index_by_grams(host, 4)
            eng = tp.GramShardedEngine(ix, make_mesh(4, tp.AXIS, device=dev))
        else:
            ix = dp_tp.shard_index_2d(host, 2, 2)
            eng = dp_tp.DpTpEngine(ix, dp_tp.make_mesh_2d(2, 2, device=dev))
        shard_s = time.perf_counter() - t1
        _reset_sharded_counts()
        res, warm_s, rep_s = _timed_batches(eng, qs, threshold, limit)
        got_b = eng.search_batch(brute_q, threshold, limit)
        torch.cuda.synchronize()
        counts = _sharded_counts()
        if counts["k5"] <= 0 or counts["expand"] <= 0 or counts["k5_plain"] or counts["k6_plain"]:
            raise AssertionError(f"{name}: counts {counts}")
        _check_results(res, qs, threshold, limit)
        _same_groups(res, want, f"{name} vs the single engine")
        _same_groups(got_b, want_b, f"{name} brute vs the single engine")
        med = sorted(rep_s)[len(rep_s) // 2]
        out[name] = {"shard_s": shard_s, "qps_median": len(qs) / med, "rep_s": rep_s,
                     "warmup_s": warm_s, "counts": counts}
        if name == "tp":
            items = []
            for pos, q in enumerate(qs[:N_TP_HITS]):
                qn, ql = eng._normalize_query(q)
                items.append((pos, qn, ql, None))
            qp = eng._chunk_qp(items)
            b, qtok, qlens, slots, nqg, use_short, _ = eng._prep_rows(items, qp)
            shards = eng._leaves()
            qbufs = replicate((qtok, qlens, slots, nqg, use_short), eng.mesh.row_devices)
            tl = int(shards[0]["long_lengths"].shape[0])
            got = tp._summed_hits(eng.mesh, shards, qbufs, ix.g_c, tl,
                                  eng._s_cap(slots, len(items)))
            di = host.device
            full = host.host_posting_lens[np.clip(slots, 0, None)] * (slots >= 0)
            cap = _next_pow2(max(int(full.sum(axis=1).max()), 1), 1024)
            ref = gather_hits(di.gram_ptr, di.gram_terms,
                              torch.from_numpy(slots).to(dev), tl, cap)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise AssertionError("TP summed hits differ from gather_hits")
            out[name]["summed_hits"] = {"queries": N_TP_HITS, "equal": True,
                                        "hits_total": int(ref.sum())}
        del eng, ix
        torch.cuda.empty_cache()
    return out


def _mh_child(conn, rank: int, port: int, n_keys: int, n_queries: int,
              threshold: float, limit: int, device: str) -> None:
    """One of phase 26's two processes: builds ``bench._product_names``'s
    corpus on the CPU, joins the gloo group on localhost, and runs
    ``MultiHostShardedEngine`` with its two shards on the card: a warm-up,
    then the timed batch (wall and collective seconds) and the brute batch;
    sends back results and counts."""
    try:
        import torch
        import torch.distributed as tdist

        import bench
        from stringsearchlib_tpu_torch.config import IndexConfig
        from stringsearchlib_tpu_torch.index.build import build_index
        from stringsearchlib_tpu_torch.parallel.dist import shard_index
        from stringsearchlib_tpu_torch.parallel.multihost import (
            MultiHostShardedEngine, global_mesh, init_distributed,
        )

        t0 = time.perf_counter()
        words = bench._product_names(n_keys)
        host = build_index(words, 1, None, IndexConfig(), device="cpu")
        build_s = time.perf_counter() - t0
        init_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo")
        eng = MultiHostShardedEngine(shard_index(host, 4), global_mesh(2, device=device))
        rng = random.Random(7)
        queries = [bench._mutate(rng, rng.choice(words)) for _ in range(n_queries)]
        coll = {"s": 0.0, "n": 0}
        for name in ("all_gather", "all_reduce"):
            f = getattr(tdist, name)

            def timed(*a, _f=f, **k):
                t = time.perf_counter()
                r = _f(*a, **k)
                coll["s"] += time.perf_counter() - t
                coll["n"] += 1
                return r

            setattr(tdist, name, timed)
        _reset_sharded_counts()
        eng.search_batch(queries, threshold, limit, batch_bucket=512)
        torch.cuda.synchronize()
        tdist.barrier()
        coll.update(s=0.0, n=0)
        t1 = time.perf_counter()
        res = eng.search_batch(queries, threshold, limit, batch_bucket=512)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t1
        coll_s, coll_n = coll["s"], coll["n"]
        brute_q = _brute_queries(eng, words, device)[0]
        res_b = eng.search_batch(brute_q + ["*"], threshold, limit)
        torch.cuda.synchronize()
        conn.send({
            "rank": rank, "build_s": build_s, "wall_s": wall_s,
            "collective_s": coll_s, "collectives": coll_n,
            "routing": dict(eng.last_routing), "counts": _sharded_counts(),
            "local_shards": list(eng.mesh.shard_ids), "queries": queries,
            "brute_queries": brute_q,
            "results": [(list(k), list(v)) for k, v in res],
            "brute_results": [(list(k), list(v)) for k, v in res_b],
        })
        tdist.destroy_process_group()
    except BaseException as e:  # reported to the parent, which raises
        import traceback

        conn.send({"error": repr(e), "trace": traceback.format_exc()})
    finally:
        conn.close()


def _two_process_1m(host, words, threshold, limit, dev) -> dict:
    """Phase 26: two processes x two shards of dense_1m's corpus, both on
    the one card, over gloo on localhost (collectives staged through host
    memory): each builds the corpus itself; 256 headline-style queries and
    16 of 1-3 characters + the wildcard; both processes' results equal one
    process's ShardedEngine at S = 4 on the resident index."""
    import multiprocessing
    import socket

    import torch

    from stringsearchlib_tpu_torch.parallel.dist import (
        ShardedEngine, make_mesh, shard_index,
    )

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # localhost only
    ctx = multiprocessing.get_context("spawn")
    conns, procs = [], []
    t0 = time.perf_counter()
    try:
        for rank in range(2):
            parent, child = ctx.Pipe(duplex=False)
            p = ctx.Process(target=_mh_child, daemon=True, args=(
                child, rank, port, len(words), N_MH, threshold, limit, str(dev)))
            p.start()
            child.close()
            conns.append(parent)
            procs.append(p)
        outs = []
        for c in conns:
            if not c.poll(600):
                raise AssertionError("a phase 26 process sent nothing in 600 s")
            outs.append(c.recv())
        for p in procs:
            p.join(60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(30)
    wall_s = time.perf_counter() - t0
    for o in outs:
        if "error" in o:
            raise AssertionError(f"phase 26 rank failed: {o['error']}\n{o.get('trace')}")
    one = ShardedEngine(shard_index(host, 4), make_mesh(4, device=dev))
    want = one.search_batch(outs[0]["queries"], threshold, limit, batch_bucket=512)
    want_b = one.search_batch(outs[0]["brute_queries"] + ["*"], threshold, limit)
    torch.cuda.synchronize()
    del one
    torch.cuda.empty_cache()
    for o in outs:
        if o["queries"] != outs[0]["queries"]:
            raise AssertionError("the two processes sent different queries")
        _same_groups(o["results"], want, f"rank {o['rank']} vs one process at S = 4")
        _same_groups(o["brute_results"], want_b, f"rank {o['rank']} brute vs one process")
        c = o["counts"]
        if c["k5_plain"] or c["k6_plain"] or c["k5"] <= 0 or c["int_mm"] + c["expand"] <= 0:
            raise AssertionError(f"rank {o['rank']}: counts {c}")
    if outs[0]["results"] != outs[1]["results"]:
        raise AssertionError("the two processes' results differ")
    return {
        "processes": 2, "shards_per_process": 2, "backend": "gloo",
        "wall_s_total": wall_s,
        "per_rank": [{k: o[k] for k in ("rank", "build_s", "wall_s", "collective_s",
                                        "collectives", "routing", "counts", "local_shards")}
                     for o in outs],
        "qps": [N_MH / o["wall_s"] for o in outs],
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--keys", type=int, default=10_000_000)
    ap.add_argument("--rows2d", type=int, default=1_000_000,
                    help="rows of the weighted 2-D index (phase 8)")
    ap.add_argument("--rows2d-bitmap", type=int, default=500_000,
                    help="rows of the weighted 2-D index whose packed bitmap "
                         "fits its budget (phase 13)")
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

    # the oracle of phase 22 builds over the 2-D corpus in a process of its
    # own (no CUDA there) while the card's phases run
    oracle_job = _OracleJob(_oracle_child, args.rows2d, N_LONG_2D, N_LONG_ORACLE,
                            THRESHOLD)
    # and phase 24's, over the headline corpus
    oracle_10m = _OracleJob(_oracle_child_10m, args.keys, N_ORACLE_10M, THRESHOLD)
    try:
        _phases(args, smi, kind, count, dev, oracle_job, oracle_10m)
    finally:
        oracle_job.stop()
        oracle_10m.stop()


def _phases(args, smi: str, kind: str, count: int, dev, oracle_job, oracle_10m) -> None:
    """Phases 2-26 and the two result lines, on card ``dev``."""
    import torch

    # -- 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    sys.path.insert(0, _ROOT)
    import numpy as np

    import bench
    from stringsearchlib_tpu_torch import StringSearchIndex
    from stringsearchlib_tpu_torch.config import IndexConfig
    from stringsearchlib_tpu_torch.index import build as buildmod
    from stringsearchlib_tpu_torch.index import native as nativelib
    from stringsearchlib_tpu_torch.ops import bitmap_matmul as bmm
    from stringsearchlib_tpu_torch.ops import kernels
    from stringsearchlib_tpu_torch.ops.bitmap_matmul import g_padding
    from stringsearchlib_tpu_torch.search.candidates import query_counts
    from stringsearchlib_tpu_torch.search.engine import SearchEngine
    from stringsearchlib_tpu_torch.search.sketch import bucket_of

    import hits_ab
    from stringsearchlib_tpu_torch.ops import dp_match as k5
    from stringsearchlib_tpu_torch.ops import probes

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        # ptxas's registers and spills of K5's instances and of K6's
        # expansion, compiled beside the package's kernels
        ptxas = pool.submit(hits_ab._nvcc_jobs, {
            name: os.path.join(_ROOT, "stringsearchlib_tpu_torch", "csrc", f"{name}.cu")
            for name in ("dp_match", "gather_tables", "probe_hits", "probe_stream")},
            os.path.join(_ROOT, "build", "ptxas"), ("cubin",))
        sos = kernels.build_kernels()
        for name in sos:
            kernels.lib(name)
        native = nativelib.get_native() is not None
        logs = ptxas.result()
    k5_ptxas = _k5_instances(logs["dp_match"]["ptxas"])
    want = {f"{t} nw={nw} qc={qc}" for t in ("uint8", "int32") for nw in k5._WORDS
            for qc in (k5._LANES // nw, 1)} | {"uint8 scratch", "int32 scratch"}
    spills = {k: v for k, v in k5_ptxas.items()
              if "nw=" in k and (v["spill_stores"] or v["spill_loads"])}
    if set(k5_ptxas) != want or spills:
        raise AssertionError(f"K5's register instances: {k5_ptxas}")
    expand_ptxas = [{"registers": r, "spill_stores": st, "spill_loads": ld}
                    for fn, (r, st, ld) in hits_ab._ptxas(logs["gather_tables"]["ptxas"]).items()
                    if "expand_postings_kernel" in fn]
    if len(expand_ptxas) != 1 or expand_ptxas[0]["spill_stores"] or expand_ptxas[0]["spill_loads"]:
        raise AssertionError(f"K6's expansion kernel: {expand_ptxas}")
    expand_ptxas = expand_ptxas[0]
    # the probe instances: 7 epilogues at 16 queries a block, P6's at 32, the stream
    epi_names = {str(code): name for name, (code, _, _) in probes.EPILOGUES.items()}
    probe_ptxas = {}
    for src in ("probe_hits", "probe_stream"):
        for fn, (r, st, ld) in hits_ab._ptxas(logs[src]["ptxas"]).items():
            m = re.search(r"probe_hits_kernelILi(\d+)ELi(\d+)E", fn)
            key = f"{epi_names[m.group(1)]} qpb{m.group(2)}" if m else "stream"
            probe_ptxas[key] = {"registers": r, "spill_stores": st, "spill_loads": ld}
    if (len(probe_ptxas) != len(probes.EPILOGUES) + 2
            or any(v["spill_stores"] or v["spill_loads"] for v in probe_ptxas.values())):
        raise AssertionError(f"the probe kernels' instances: {probe_ptxas}")
    _phase("build", t0, kernel_sos=",".join(os.path.relpath(p, _ROOT) for p in sos.values()),
           native_builder=native, k5_ptxas=json.dumps(k5_ptxas, separators=(",", ":")),
           expand_ptxas=json.dumps(expand_ptxas, separators=(",", ":")),
           probe_ptxas=json.dumps(probe_ptxas, separators=(",", ":")))

    # -- 3. K1 vs plain, random tables -------------------------------------
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(1234)
    max_err = 0
    n_cases = 0
    for gp in (128, 2816, 6144):
        for b in (16, 256, 512):
            for total in (31, 127):
                planes, qcnt = _random_case(gen, b, gp, 3, total, dev)
                for t in (planes, bmm.from_tile_major(planes).contiguous()):
                    hits, bmax = bmm.bitmap_hits_bmax(qcnt, t)
                    rh, rb = bmm.bitmap_hits_bmax_ref(qcnt, t)
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
                            f"sum={total} {t.ndim}-D table max_abs_err={err}"
                        )
    edges = _edge_cases(gen, dev)
    for name, planes, qcnt in edges:
        hits, bmax = bmm.bitmap_hits_bmax(qcnt, planes)
        rh, rb = bmm.bitmap_hits_bmax_ref(qcnt, planes)
        torch.cuda.synchronize()
        err = max(_max_abs_err(hits, rh), _max_abs_err(bmax, rb))
        max_err = max(max_err, err)
        n_cases += 1
        if err or not torch.equal(hits, rh) or not torch.equal(bmax, rb):
            raise AssertionError(f"K1 differs from its plain version on {name}: {err}")
    _phase("k1_random", t0, cases=n_cases, max_abs_err=max_err,
           edges=",".join(n for n, _, _ in edges))

    # -- 15. K5 vs plain, random cases ---------------------------------------
    t0 = time.perf_counter()
    k5_err, k5_cases, k5_timing = _k5_random(gen, dev)
    print(json.dumps({"k5_random_timing": k5_timing, "card": smi}), flush=True)
    _phase("k5_random", t0, cases=k5_cases, max_abs_err=k5_err)

    # -- 4. main path -----------------------------------------------------------
    t0 = time.perf_counter()
    words = bench._product_names(args.keys, seed=2)
    t_corpus = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    idx = StringSearchIndex(words, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t1
    breakdown = dict(buildmod.LAST_BUILD_BREAKDOWN)
    host, engine = idx.host, idx.engine
    t1 = time.perf_counter()
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
    threshold, limit = THRESHOLD, LIMIT
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
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
    launches = bmm.K1_LAUNCHES
    ref_calls = bmm.K1_REF_CALLS
    routing = dict(engine.last_routing)
    peak_search = int(torch.cuda.max_memory_allocated())
    if routing.get("variant") != "bitmap_kernel" or not routing.get("hstar"):
        raise AssertionError(f"main path did not take bitmap_kernel + h*: {routing}")
    if launches <= 0 or ref_calls:
        raise AssertionError(f"K1 launches={launches} plain calls={ref_calls}")
    _check_results(results, queries, threshold, limit)
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
        bound = _hits_bound(q, int(table.shape[0]), bmax=True)
        timing[b] = {
            "k1_ms": k_ms, "device_ms": _device_ms(lambda: bmm.bitmap_hits_bmax(q, table), 5),
            "plain_ms": p_ms, "bound_ms": bound[0], "bound_by": bound[1],
            **_hits_issue(q, int(table.shape[0])),
            "hits_gb_per_s": hbytes / k_ms / 1e6,
        }
        torch.cuda.empty_cache()
    print(json.dumps({"k1_timing": timing, "card": smi}), flush=True)
    _phase("k1_real_table", t0, max_abs_err=real_err, step=step)

    # -- 21. the K1 probes P1-P9 ---------------------------------------------
    t0 = time.perf_counter()
    probe_edges = _probe_random(gen, dev)
    probe_run = _probe_phase(table, slots, dev)
    print(json.dumps({"probes": probe_run, "probe_edges": probe_edges, "card": smi}),
          flush=True)
    _phase("probes", t0, launches=probe_run["launches"],
           edge_cases=sum(n for n, _ in probe_edges.values()),
           max_abs_err=max(max(e for _, e in probe_edges.values()),
                           max(r["max_abs_err"] for r in probe_run["results"])))

    # -- 6. exactness against the dense path -----------------------------------
    t0 = time.perf_counter()
    _check_exact(engine, queries[:32], results[:32], threshold, limit)
    _phase("exactness", t0, queries=32)

    # -- 11. the row gather vs plain, random tables --------------------------
    t0 = time.perf_counter()
    g_err, g_cases, g_timing = _gather_random(gen, dev, int(table.shape[0]))
    print(json.dumps({"gather_random_timing": g_timing, "card": smi}), flush=True)
    _phase("gather_random", t0, cases=g_cases, max_abs_err=g_err)

    # -- 12. the gathered-row route on the 10M index ----------------------------
    t0 = time.perf_counter()
    gathered = _gathered_route(engine, table, queries, threshold, limit, dev)
    g_err = max(g_err, gathered["max_abs_err"])
    print(json.dumps({"gathered_route": gathered, "card": smi}), flush=True)
    _phase("gathered_route", t0, launches=gathered["gather_launches"],
           passes=gathered["passes_by_variant"])

    # -- 23. persistence and the flat API on the 10M index -------------------
    t0 = time.perf_counter()
    persist = _persistence_api(idx, queries, results, routing, build_s, threshold, limit)
    print(json.dumps({"persistence_api": persist, "card": smi}), flush=True)
    _phase("persistence_api", t0, save_s=round(persist["save_s"], 2),
           load_s=round(persist["load_s"], 2), build_s=round(build_s, 2),
           loaded_qps=round(persist["loaded_qps_median"], 2))

    # -- 24. term-sharded at 10M keys, S = 8 then S = 4 ----------------------
    t0 = time.perf_counter()
    sharded, sharded_first = _sharded_10m(host, engine, words, queries, results,
                                          threshold, limit, dev)
    print(json.dumps({"sharded_10m": sharded, "card": smi}), flush=True)
    _phase("sharded_10m", t0,
           qps_s8=round(sharded["s8"]["qps_median"], 2),
           qps_s4=round(sharded["s4"]["qps_median"], 2),
           shard_s8_s=round(sharded["s8"]["shard_index_s"], 2),
           shard_s4_s=round(sharded["s4"]["shard_index_s"], 2),
           merge_ms=round(sharded["s8"]["step_times"]["merge_ms"], 4))
    del idx, engine, host, bm, table, q, results
    torch.cuda.empty_cache()

    # -- 7. K2 vs plain, random tables -------------------------------------
    t0 = time.perf_counter()
    k2_err = 0
    n_cases = 0
    for gp in (128, 2816, 8192):
        for b in (16, 256, 512):
            for total in (31, 127):
                planes, qcnt = _random_case(gen, b, gp, 3, total, dev)
                for t in (planes, bmm.from_tile_major(planes).contiguous()):
                    hits = bmm.bitmap_hits(qcnt, t)
                    rh = bmm.bitmap_hits_ref(qcnt, t)
                    torch.cuda.synchronize()
                    err = int((hits.int() - rh.int()).abs().max())
                    k2_err = max(k2_err, err)
                    n_cases += 1
                    if err or not torch.equal(hits, rh):
                        raise AssertionError(
                            f"K2 differs from its plain version: gp={gp} b={b} "
                            f"sum={total} {t.ndim}-D table max_abs_err={err}"
                        )
    for name, planes, qcnt in edges:
        hits = bmm.bitmap_hits(qcnt, planes)
        rh = bmm.bitmap_hits_ref(qcnt, planes)
        torch.cuda.synchronize()
        err = _max_abs_err(hits, rh)
        k2_err = max(k2_err, err)
        n_cases += 1
        if err or not torch.equal(hits, rh):
            raise AssertionError(f"K2 differs from its plain version on {name}: {err}")
    del edges
    _phase("k2_random", t0, cases=n_cases, max_abs_err=k2_err)

    # -- 8. the weighted 2-D path (bench.py index2d_1m_rows) -------------------
    t0 = time.perf_counter()
    n2 = args.rows2d
    words2 = _words_2d(n2)
    weights2 = np.tile(np.array([1.0, 0.4]), n2)
    t_corpus = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    host2 = buildmod.build_index(words2, 2, weights2, IndexConfig(), device=dev)
    torch.cuda.synchronize()
    build2_s = time.perf_counter() - t1
    breakdown2 = dict(buildmod.LAST_BUILD_BREAKDOWN)
    engine2 = SearchEngine(host2)
    t1 = time.perf_counter()
    sk = host2.sketch_tables(engine2.SKETCH_BUDGET)
    torch.cuda.synchronize()
    sketch_s = time.perf_counter() - t1
    if sk is None:
        raise AssertionError("no sketch table for the 2-D index")
    inc, tg = sk[0], sk[1]
    nb2, _ = host2.bitmap_layout()
    print(json.dumps({
        "build_breakdown_2d": breakdown2, "corpus_s": round(t_corpus, 2),
        "build_s": round(build2_s, 2), "sketch_table_s": round(sketch_s, 2),
        "n_rows": n2, "n_terms": host2.n_terms, "n_grams": host2.n_grams,
        "uniform_weights": host2.uniform_weights,
        "packed_bitmap_would_be_bytes": int(g_padding(host2.n_grams) * nb2),
        "sketch_inc_bytes": int(inc.numel()), "sketch_inc_shape": list(inc.shape),
        "sketch_tg_bytes": int(tg.numel() * 4), "d_log2": int(sk[3]),
        "peak_mem_build_bytes": int(torch.cuda.max_memory_allocated()),
    }), flush=True)

    rng = random.Random(7)
    queries2 = [bench._mutate(rng, rng.choice(words2)) for _ in range(N_QUERIES_2D)]
    torch.cuda.reset_peak_memory_stats()
    bmm.K1_LAUNCHES = bmm.K1_REF_CALLS = bmm.K2_LAUNCHES = bmm.K2_REF_CALLS = 0
    t1 = time.perf_counter()
    results2 = engine2.search_batch(queries2, threshold, limit, batch_bucket=512)
    torch.cuda.synchronize()
    warm2_s = time.perf_counter() - t1
    rep2_s = []
    for _ in range(REPS):
        t1 = time.perf_counter()
        results2 = engine2.search_batch(queries2, threshold, limit, batch_bucket=512)
        torch.cuda.synchronize()
        rep2_s.append(time.perf_counter() - t1)
    k2_launches = bmm.K2_LAUNCHES
    k2_ref_calls = bmm.K2_REF_CALLS
    routing2 = dict(engine2.last_routing)
    peak2 = int(torch.cuda.max_memory_allocated())
    if routing2.get("variant") != "sketch_packed":
        raise AssertionError(f"the 2-D path did not take sketch_packed: {routing2}")
    if k2_launches <= 0 or k2_ref_calls:
        raise AssertionError(f"K2 launches={k2_launches} plain calls={k2_ref_calls}")
    # float32 products: threshold * 0.4 less one part in 1e6
    _check_results(results2, queries2, threshold * 0.4 * (1 - 1e-6), limit)
    med2 = sorted(rep2_s)[len(rep2_s) // 2]
    trace2 = _trace(
        lambda: engine2.search_batch(queries2, threshold, limit, batch_bucket=512)
    )
    print(json.dumps({"traced_batch_2d": trace2}), flush=True)
    print(json.dumps({
        "qps_median_2d": N_QUERIES_2D / med2, "rep_s": rep2_s, "warmup_s": warm2_s,
        "routing": routing2, "k2_launches": k2_launches,
        "peak_mem_search_bytes": peak2,
        "mean_results": sum(len(k) for k, _ in results2) / len(results2),
    }), flush=True)
    _phase("path_2d", t0, qps=round(N_QUERIES_2D / med2, 2), launches=k2_launches)

    # -- 9. K2 on the real sketch table ---------------------------------------
    t0 = time.perf_counter()
    items2 = []
    for pos, q in enumerate(queries2):
        qnorm, qlen = engine2._normalize_query(q)
        items2.append((pos, qnorm, qlen, None))
    _, _, _, slots2, _, _, _ = engine2._prep_rows(items2, 32)
    d_log2 = int(sk[3])
    step2 = int(routing2["step"])
    k2_real_err = 0
    k2_timing = {}
    for b in sorted({256, step2}):
        q = query_counts(
            bucket_of(torch.from_numpy(np_tile(slots2, b)).to(dev), d_log2),
            1 << d_log2,
        )
        kh = bmm.bitmap_hits(q, inc)
        rh = bmm.bitmap_hits_ref(q, inc)
        torch.cuda.synchronize()
        err = _max_abs_err(kh, rh)
        k2_real_err = max(k2_real_err, err)
        if err or not torch.equal(kh, rh):
            raise AssertionError(f"K2 differs on the real sketch table at B={b}: {err}")
        del kh, rh
        torch.cuda.empty_cache()
        k_ms = _cuda_ms(lambda: bmm.bitmap_hits(q, inc), 5)
        p_ms = _cuda_ms(lambda: bmm.bitmap_hits_ref(q, inc), 1)
        bound = _hits_bound(q, int(inc.shape[0]), bmax=False)
        k2_timing[b] = {
            "k2_ms": k_ms, "device_ms": _device_ms(lambda: bmm.bitmap_hits(q, inc), 5),
            "plain_ms": p_ms, "bound_ms": bound[0], "bound_by": bound[1],
            **_hits_issue(q, int(inc.shape[0])),
            "hits_gb_per_s": b * tg.shape[0] / k_ms / 1e6,
            "max_bucket_mult": int(q.max()),
        }
        torch.cuda.empty_cache()
    print(json.dumps({"k2_timing": k2_timing, "card": smi}), flush=True)
    _phase("k2_real_table", t0, max_abs_err=k2_real_err, step=step2)

    # -- 10. 2-D exactness against the dense path --------------------------------
    t0 = time.perf_counter()
    _check_exact(engine2, queries2[:32], results2[:32], threshold, limit)
    _phase("exactness_2d", t0, queries=32)

    # -- 22. the unpacked sketch on the 2-D index ------------------------------
    t0 = time.perf_counter()
    unpacked = _sketch_unpacked(engine2, queries2, results2, words2, threshold, limit,
                                dev, oracle_job)
    print(json.dumps({"sketch_unpacked": unpacked, "card": smi}), flush=True)
    _phase("sketch_unpacked", t0, d=unpacked["table"]["d"],
           qps=round(unpacked["phase8_queries"]["qps_median"], 2),
           long_qps=round(unpacked["long_queries"]["qps_median"], 2),
           int_mm_b256_ms=round(unpacked["int_mm"]["b256"]["ms"], 4))
    host2._sketch_cache.pop(False, None)
    del sk, inc, tg, q, results2
    torch.cuda.empty_cache()

    # -- 16. K6 vs plain, random indices into the 2-D index's postings -------
    t0 = time.perf_counter()
    k6_cases, k6_timing = _k6_random(host2.device.gram_terms, dev)
    print(json.dumps({"k6_random_timing": k6_timing, "card": smi}), flush=True)
    k6_err = max(c["max_abs_err"] for c in k6_timing.values())
    _phase("k6_random", t0, cases=k6_cases, max_abs_err=k6_err)

    # -- 18. tiny runs on the 2-D index ------------------------------------------
    t0 = time.perf_counter()
    tiny2d = _tiny_runs_2d(engine2, words2, threshold, limit)
    print(json.dumps({"tiny_runs_2d": tiny2d, "card": smi}), flush=True)
    _phase("tiny_runs_2d", t0, passes=tiny2d["first_pass_variants"],
           expand_launches=tiny2d["counts"]["expand"])

    # -- 19. the brute tier on the 2-D index --------------------------------------
    t0 = time.perf_counter()
    brute = _brute_2d(engine2, words2, threshold, limit, dev)
    print(json.dumps({"brute_2d": brute, "card": smi}), flush=True)
    k5_long = {k: brute[k] for k in ("k5_b16", "k5_b1")}
    _phase("brute_2d", t0, k5_launches=brute["counts"]["k5"])
    del engine2, host2, words2
    torch.cuda.empty_cache()

    # -- 13. the weighted bitmap route (2-D layout, table within budget) -----
    t0 = time.perf_counter()
    weighted = _weighted_bitmap_route(args.rows2d_bitmap, threshold, limit, dev)
    print(json.dumps({"weighted_bitmap": weighted, "card": smi}), flush=True)
    _phase("weighted_bitmap", t0, qps=round(weighted["qps_median"], 2),
           k2_launches=weighted["k2_launches"])
    torch.cuda.empty_cache()

    # -- 14. wide_100k_g2 ------------------------------------------------------
    t0 = time.perf_counter()
    wide = _wide_g2_route(threshold, limit, dev)
    print(json.dumps({"wide_100k_g2": wide, "card": smi}), flush=True)
    _phase("wide_g2", t0, qps=round(wide["qps_median"], 2),
           k2_launches=wide["k2_launches"])
    torch.cuda.empty_cache()

    # -- 17. wide_100k_g3: the sorted runs -------------------------------------------
    t0 = time.perf_counter()
    wide3 = _wide_g3_route(threshold, limit, dev)
    print(json.dumps({"wide_100k_g3": wide3, "card": smi}), flush=True)
    _phase("wide_g3", t0, qps=round(wide3["qps_median"], 2),
           k5_launches=wide3["counts"]["k5"], expand_launches=wide3["counts"]["expand"])
    torch.cuda.empty_cache()

    # -- 20. dense_1m: the gram-matrix route -------------------------------------
    t0 = time.perf_counter()
    mm, dense_1m = _matmul_1m(threshold, limit, dev)
    print(json.dumps({"matmul_1m": mm, "card": smi}), flush=True)
    _phase("matmul_1m", t0, qps=round(mm["qps_median"], 2),
           single_p50=round(mm["single_query_ms"]["p50"], 3))

    # -- 25. gram-sharded and DP x TP on dense_1m's index -----------------------
    t0 = time.perf_counter()
    tpdp = _tp_dp_1m(*dense_1m, threshold, limit, dev)
    print(json.dumps({"tp_dp_tp_1m": tpdp, "card": smi}), flush=True)
    _phase("tp_dp_tp_1m", t0, tp_qps=round(tpdp["tp"]["qps_median"], 2),
           dp_tp_qps=round(tpdp["dp_tp"]["qps_median"], 2))

    # -- 26. two processes x two shards over gloo ---------------------------------
    t0 = time.perf_counter()
    mh = _two_process_1m(dense_1m[0], dense_1m[2], threshold, limit, dev)
    print(json.dumps({"two_process_1m": mh, "card": smi}), flush=True)
    _phase("two_process_1m", t0, wall_s=[round(r["wall_s"], 3) for r in mh["per_rank"]],
           collective_s=[round(r["collective_s"], 3) for r in mh["per_rank"]])
    del dense_1m
    torch.cuda.empty_cache()

    # -- 24, concluded: phase 24's first queries against the oracle ------------
    t0 = time.perf_counter()
    sharded["oracle"] = _sharded_oracle(sharded_first, queries, limit, oracle_10m)
    print(json.dumps({"sharded_10m_oracle": sharded["oracle"], "card": smi}), flush=True)
    _phase("sharded_10m_oracle", t0, queries=sharded["oracle"]["n"],
           wait_s=round(sharded["oracle"]["wait_s"], 2))

    src = "stringsearchlib_tpu_torch/csrc/bitmap_hits.cu"
    gsrc = "stringsearchlib_tpu_torch/csrc/gather_rows.cu"
    # K5's and K6's expansion's launches on the sharded paths (phases 24-26)

    def sharded_launches(key: str) -> dict:
        return {
            "sharded_10m": sum(sharded[f"s{n}"]["counts"][key] for n in (8, 4))
            + sharded["s4"]["brute_counts"][key],
            "tp_dp_tp_1m": sum(tpdp[n]["counts"][key] for n in ("tp", "dp_tp")),
            "two_process_1m": sum(r["counts"][key] for r in mh["per_rank"]),
        }

    k5_paths = {"wide_g3": wide3["counts"]["k5"], **sharded_launches("k5")}
    ex_paths = {"wide_g3": wide3["counts"]["expand"], **sharded_launches("expand")}
    g_real = gathered["gather_real_rows"]
    k5_real = wide3["route_kernels"]["k5"]
    k6_real = wide3["route_kernels"]["k6"]
    ex_real = wide3["route_kernels"]["expand"]
    print(json.dumps({"kernels": [{
        "name": "bitmap_hits_bmax",
        "route": "cuda",
        "source": src,
        "replaces": "stringsearchlib_tpu/ops/bitmap_matmul.py:401",
        "launches": launches,
        "max_abs_err": max(max_err, real_err),
        "ms": timing[256]["k1_ms"],
        "device_ms": timing[256]["device_ms"],
        "plain_ms": timing[256]["plain_ms"],
        "bound_ms": timing[256]["bound_ms"],
        "bound_by": timing[256]["bound_by"],
        "library_ms": None,
    }, {
        "name": "bitmap_hits",
        "route": "cuda",
        "source": src,
        "replaces": "stringsearchlib_tpu/ops/bitmap_matmul.py:317",
        "launches": k2_launches,
        "max_abs_err": max(k2_err, k2_real_err),
        "ms": k2_timing[256]["k2_ms"],
        "device_ms": k2_timing[256]["device_ms"],
        "plain_ms": k2_timing[256]["plain_ms"],
        "bound_ms": k2_timing[256]["bound_ms"],
        "bound_by": k2_timing[256]["bound_by"],
        "library_ms": None,
    }] + [{
        "name": name,
        "route": "cuda",
        "source": gsrc,
        "replaces": f"stringsearchlib_tpu/ops/bitmap_matmul.py:{line}",
        "launches": gathered["gather_launches"],
        "max_abs_err": g_err,
        "ms": g_real["ms"],
        "device_ms": g_real["device_ms"],
        "plain_ms": g_real["plain_ms"],
        "bound_ms": g_real["bound_ms"],
        "bound_by": g_real["bound_by"],
        "library_ms": g_real["index_select_ms"],
    } for name, line in (("gather_rows_dma", 465), ("gather_rows_pallas", 423))] + [{
        "name": "dp_match",
        "route": "cuda",
        "source": "stringsearchlib_tpu_torch/csrc/dp_match.cu",
        "replaces": "tools/experimental/dp_pallas.py:86",
        "launches": sum(k5_paths.values()),
        "launches_by_path": k5_paths,
        "max_abs_err": k5_err,
        "ms": k5_real["ms"],
        "device_ms": k5_real["device_ms"],
        "plain_ms": k5_real["plain_ms"],
        "bound_ms": k5_real["bound_ms"],
        "bound_by": k5_real["bound_by"],
        "dp_cell_bound_ms": k5_real["dp_cell_bound_ms"],
        "long_tier": k5_long,
        "ptxas": k5_ptxas,
        "library_ms": None,
    }, {
        "name": "gather_tables",
        "route": "cuda",
        "source": "stringsearchlib_tpu_torch/csrc/gather_tables.cu",
        "replaces": "tools/experimental/vgather.py:65",
        # K6_LAUNCHES counts both entries of the source; no route runs this
        # one since expand_postings took its place on the runs routes
        "launches": wide3["counts"]["k6"] - wide3["counts"]["expand"],
        "note": "the TPU kernel's own contract, held against its plain version in "
                "phase 16 and at the wide g3 route's old-path indices; no route runs it",
        "max_abs_err": max(k6_err, k6_real["max_abs_err"]),
        "ms": k6_real["ms"],
        "device_ms": k6_real["device_ms"],
        "plain_ms": k6_real["plain_ms"],
        "bound_ms": k6_real["bound_ms"],
        "bound_by": k6_real["bound_by"],
        "library_ms": None,
    }, {
        "name": "expand_postings",
        "route": "cuda",
        "source": "stringsearchlib_tpu_torch/csrc/gather_tables.cu",
        "replaces": "tools/experimental/vgather.py:65",
        "launches": sum(ex_paths.values()),
        "launches_by_path": ex_paths,
        "max_abs_err": max([ex_real["max_abs_err"]]
                           + [c["max_abs_err"] for c in tiny2d["expand"].values()]),
        "ms": ex_real["ms"],
        "device_ms": ex_real["device_ms"],
        "plain_ms": ex_real["plain_ms"],
        "bound_ms": ex_real["bound_ms"],
        "bound_by": ex_real["bound_by"],
        "old_path_ms": ex_real["old_path_ms"],
        "old_path_device_ms": ex_real["old_path_device_ms"],
        "launches_per_expansion": ex_real["launches_per_expansion"],
        "ptxas": expand_ptxas,
        "library_ms": None,
    }] + [_probe_entry(probe, line, probe_run, probe_edges, probe_ptxas)
          for probe, line in PROBES]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count,
    }}), flush=True)


if __name__ == "__main__":
    main()
