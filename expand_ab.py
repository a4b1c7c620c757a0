#!/usr/bin/env python3
"""Times bodies of K6's postings expansion (``expand_postings_launch`` in
``csrc/gather_tables.cu``) against each other on one CUDA card.

A body is a CUDA source with the package's C entry
``expand_postings_launch``.  The package's source as it is is the body
``new``; ``--body NAME=PATH`` adds another (a copy of the package's source
with another tile size or grid, say).  Every body is built by
``hits_ab._nvcc_jobs`` (the package's nvcc flags, one process per build,
all started together; a cubin beside each library for ptxas's registers
and spills).

Shapes: the operands a ``wide_100k_g3`` batch hands ``expand_postings``
(recorded), and on the 2-D index (``bench.py`` ``index2d_1m_rows``) those
of chip_smoke.py's tiny-runs phase: a description single and a batch of 8
description queries on tiny_runs, and the dense path's ``gather_hits``
over the phase's 128 queries (``chip_smoke._expansion_operands``).  On
each, every body is held bit-identical to ``expand_postings_ref``, then
timed in turns (``chip_smoke._in_turns``: the bodies in order, then in
reverse), each turn the mean of ``--reps`` calls with CUDA events, then in
device time (``chip_smoke._queued_ms``: calls queued behind a spin kernel),
beside the bound (``chip_smoke._expand_bound``).  The package body is also
timed on the same shape with every slot absent: the scan and the output's
stores alone, the least time any body that reads the runs faster could
reach.

At the wide g3 route's operands, the host cost of each piece of a call
(``timeit`` on the card's host): the package wrapper, the old path's
wrapper (the CSR expand and the gather kernel), ``torch.empty``, the two
ways to read the current stream, and the bare ctypes launch.  End to end,
the old path against the package kernel in turns in one process (old, new,
new, old, three times), every ``expand_postings`` binding of the search
modules swapped: q/s of the wide g3 route's 256-query batches (median of
``--reps-e2e``) and the p50 of the tiny-runs description singles on the
2-D index.

Writes every reading to ``--out`` (default ``build/expand_ab/expand_ab.json``)
and prints one JSON line per shape.

Usage:  python3 expand_ab.py [--body NAME=PATH ...] [--rows2d N] [--reps N]
                             [--reps-e2e N] [--out PATH]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import random
import statistics
import subprocess
import sys
import time
import timeit

_ROOT = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(_ROOT, "build", "expand_ab")
_SRC = os.path.join(_ROOT, "stringsearchlib_tpu_torch", "csrc", "gather_tables.cu")
_T0 = time.perf_counter()


def _log(*a) -> None:
    print(f"[{time.perf_counter() - _T0:7.1f}s]", *a, flush=True)


def _e2e(run, reps: int, rounds: int = 3) -> dict:
    """``run()`` (returning a time) with the old path and with the package
    kernel in turns, ``rounds`` times old, new, new, old, each turn the
    median of ``reps`` runs after one warm-up; every ``expand_postings``
    binding of the search modules swapped."""
    import chip_smoke as cs
    from stringsearchlib_tpu_torch.ops import vgather as k6
    from stringsearchlib_tpu_torch.search import candidates, overlap

    def turn(fn):
        with cs._bound_as((candidates, overlap), "expand_postings", fn):
            run()
            return statistics.median(run() for _ in range(reps))

    turns = {"old": [], "new": []}
    for _ in range(rounds):
        for side, got in cs._in_turns(
                {"old": cs._old_expansion, "new": k6.expand_postings}, turn).items():
            turns[side] += got
    return turns


def _host_costs(a, entry, reps: int = 2000) -> dict:
    """Microseconds of host time per call of each piece of an expansion
    call on operands ``a`` (timeit, the queue drained after each piece)."""
    import torch

    import chip_smoke as cs
    from stringsearchlib_tpu_torch.ops import vgather as k6

    ptr, terms, slots, s_cap, fill = a
    b, qmax = slots.shape
    out = torch.empty((b, s_cap), dtype=torch.int32, device=slots.device)
    stream = torch._C._cuda_getCurrentRawStream(slots.device.index)
    pieces = {
        "wrapper": lambda: k6.expand_postings(*a),
        "old_path": lambda: cs._old_expansion(*a),
        "torch_empty": lambda: torch.empty((b, s_cap), dtype=torch.int32,
                                           device=slots.device),
        "current_stream": lambda: torch.cuda.current_stream().cuda_stream,
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(0),
        "ctypes_launch": lambda: entry(ptr.data_ptr(), terms.data_ptr(), slots.data_ptr(),
                                       out.data_ptr(), ptr.shape[0] - 1, terms.shape[0],
                                       b, qmax, s_cap, fill & 0xFFFFFFFF, stream),
    }
    res = {}
    for name, fn in pieces.items():
        fn()
        torch.cuda.synchronize()
        t = timeit.timeit(fn, number=reps)
        torch.cuda.synchronize()
        res[name] = t / reps * 1e6
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--body", action="append", default=[],
                    help="NAME=PATH: another source with the package's entry")
    ap.add_argument("--rows2d", type=int, default=1_000_000)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--reps-e2e", type=int, default=5)
    ap.add_argument("--out", default=os.path.join(_BUILD, "expand_ab.json"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("expand_ab: no CUDA device")
    sys.path.insert(0, _ROOT)
    import numpy as np

    import chip_smoke as cs
    import hits_ab
    from stringsearchlib_tpu_torch.config import IndexConfig
    from stringsearchlib_tpu_torch.index import build as buildmod
    from stringsearchlib_tpu_torch.ops import kernels
    from stringsearchlib_tpu_torch.ops import vgather as k6
    from stringsearchlib_tpu_torch.search import candidates
    from stringsearchlib_tpu_torch.search.engine import SearchEngine
    from stringsearchlib_tpu_torch.tools import bench

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    _log(card)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    bodies = {}
    for spec in args.body:
        name, _, path = spec.partition("=")
        bodies[name] = os.path.abspath(path)
    bodies["new"] = _SRC
    built = hits_ab._nvcc_jobs(bodies, _BUILD)
    entries, ptxas = {}, {}
    for name, b in built.items():
        fn = ctypes.CDLL(b["so"]).expand_postings_launch
        fn.argtypes = kernels.ARGTYPES["gather_tables"]["expand_postings_launch"]
        fn.restype = ctypes.c_int
        entries[name] = fn
        ptxas[name] = {f: {"registers": r, "spill_stores": st, "spill_loads": ld}
                       for f, (r, st, ld) in hits_ab._ptxas(b["ptxas"]).items()
                       if "expand_postings" in f}
    _log("ptxas", json.dumps(ptxas))
    result: dict = {"card": card, "bodies": bodies, "ptxas": ptxas}
    names = list(bodies)

    def run(name, a):
        ptr, terms, slots, s_cap, fill = a
        b, qmax = slots.shape
        out = torch.empty((b, s_cap), dtype=torch.int32, device=dev)
        err = entries[name](ptr.data_ptr(), terms.data_ptr(), slots.data_ptr(),
                            out.data_ptr(), ptr.shape[0] - 1, terms.shape[0], b, qmax,
                            s_cap, fill & 0xFFFFFFFF, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"body {name}: cuda error {err}")
        return out

    bad = []

    def time_shape(tag, a, reps) -> dict:
        want = k6.expand_postings_ref(*a)
        identical = {n: bool(torch.equal(run(n, a), want)) for n in names}
        bad.extend(f"{tag}/{n}" for n, ok in identical.items() if not ok)
        del want
        torch.cuda.empty_cache()
        sides = {n: lambda n=n: run(n, a) for n in names}
        bound, by, sectors = cs._expand_bound(a[0], a[2], a[3])
        absent = (a[0], a[1], torch.full_like(a[2], -1), a[3], a[4])
        res = {
            "shape": [int(a[2].shape[0]), int(a[2].shape[1]), int(a[3])],
            "posting_sectors": sectors, "identical": identical,
            "ms_turns": cs._in_turns(sides, lambda f: cs._cuda_ms(f, reps)),
            "device_ms_turns": cs._in_turns(sides, lambda f: cs._queued_ms(f, reps)),
            "no_postings_device_ms": cs._queued_ms(lambda: run("new", absent), reps),
            "bound_ms": bound, "bound_by": by,
        }
        _log(tag, json.dumps(res))
        return res

    shapes = {}
    # -- wide_100k_g3: the operands a batch hands the expansion ----------------
    words = bench._wide_names(cs.N_WIDE)
    host = buildmod.build_index(words, 1, None, IndexConfig(wide=True, gram_size=3), device=dev)
    engine = SearchEngine(host)
    rng = random.Random(7)
    queries = [bench._mutate(rng, rng.choice(words)) for _ in range(cs.N_QUERIES_WIDE)]
    calls = cs._recorded_calls(candidates, "expand_postings", lambda: engine.search_batch(
        queries, 0.3, 100, batch_bucket=512))
    if not calls:
        raise AssertionError("the wide g3 batch made no expansion")
    shapes["wide_g3_route"] = time_shape("wide_g3_route", calls[0], args.reps)
    result["host_us"] = _host_costs(calls[0], entries["new"])
    _log("host_us", json.dumps(result["host_us"]))

    def batch_s():
        t1 = time.perf_counter()
        engine.search_batch(queries, 0.3, 100, batch_bucket=512)
        torch.cuda.synchronize()
        return time.perf_counter() - t1

    turns = _e2e(batch_s, args.reps_e2e)
    e2e = {"wide_g3_qps": {k: [len(queries) / t for t in v] for k, v in turns.items()}}
    _log("e2e", json.dumps(e2e))
    del engine, host, calls
    torch.cuda.empty_cache()

    # -- the 2-D index: tiny runs and the dense path ---------------------------
    rows = bench._product_names(args.rows2d, seed=5)
    descs = bench._rich_names(args.rows2d, seed=6)
    words2 = [x for kv in zip(rows, descs) for x in kv]
    del rows, descs
    weights = np.tile(np.array([1.0, 0.4]), args.rows2d)
    host2 = buildmod.build_index(words2, 2, weights, IndexConfig(), device=dev)
    engine2 = SearchEngine(host2)
    singles, batches = cs._tiny_queries(words2)
    allq = singles + [q for b in batches for q in b]
    ops, _, _ = cs._expansion_operands(engine2, allq, singles[1::2], 0.3, 100)
    for name, a in ops.items():
        shapes[name] = time_shape(name, a, 5 if name.startswith("dense") else args.reps)
    del ops
    torch.cuda.empty_cache()
    desc = singles[1::2]

    def singles_p50_ms():
        ms = []
        for q in desc:
            t1 = time.perf_counter()
            engine2.search(q, 0.3, 100)
            ms.append((time.perf_counter() - t1) * 1e3)
        return statistics.median(ms)

    e2e["tiny_runs_desc_single_p50_ms"] = _e2e(singles_p50_ms, 1)
    _log("e2e", json.dumps(e2e))
    result["e2e"] = e2e
    result["shapes"] = shapes
    result["not_identical"] = bad

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1, default=str)
    print(json.dumps({"ok": not bad, "card": card}))
    if bad:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
