#!/usr/bin/env python3
"""Times bodies of the edit-distance kernel (K5, ``csrc/dp_match.cu``)
against each other on one CUDA card, and counts their SASS.

A body is a CUDA source with the package's C entry ``dp_match_launch``,
launched as ``ops.dp_match`` plans it (``plan``: the word-count instance
and the chunk, or the scratch kernel past 8 words).  The package's own
source is always the body ``new``; ``--body NAME=PATH`` adds others.
``--parent DIR`` adds the body ``parent``: the ``dp_match`` wrapper of
another checkout of the repo (its own entry and launch choice, its kernels
built under DIR/build/kernels), imported beside this package.  The chip's
copy of the tree has no git, so the checkout is unpacked first, for
example the commit before K5's bit-parallel body:

    mkdir -p dist/parent && git archive bcc9887 | tar -x -C dist/parent
    python3 dp_ab.py --parent dist/parent

Every source is compiled with the package's nvcc flags (one process per
source, all started together) and once more to a cubin with ``-Xptxas -v``
for its registers, spills and SASS.  The shapes: the operands a
``wide_100k_g3`` batch hands the short tier's ``dp_match`` (recorded), the
2-D index's 2M-term long tier with chip_smoke.py's 16 brute-tier queries at
B = 16, 4, 2 and 1, and every ``chip_smoke.K5_CASES`` shape.  On each,
every body is held bit-identical to the plain version ``dp_match_ref``,
then timed in turns (the bodies in order, then in reverse: parent, new,
new, parent), each turn the mean of ``--reps`` calls with CUDA events
(the parent's through its wrapper, so its host work counts there), then in
device time (``chip_smoke._queued_ms``: calls queued behind a spin kernel,
so no host time counts), beside the least-work bound and the DP-cell bound
(``chip_smoke._dp_bound``).  The package body is also traced with
torch.profiler: how many of the calls' kernels the trace kept, and their
mean duration, as a check of the profiler against the queued time.

The SASS count: each kernel function's loops (backward branches) with their
instructions; for the uint8 one-word instance of 16-query chunks, the
character loop's instructions per query step (the loop's count over 16).

Writes every reading to ``--out`` (default ``build/dp_ab/dp_ab.json``), the
package body's SASS beside it (``.new.sass``), and prints one JSON line per
shape.

Usage:  python3 dp_ab.py [--parent DIR] [--body NAME=PATH ...] [--rows2d N]
                         [--reps N] [--out PATH]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import random
import subprocess
import sys
import time

_ROOT = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(_ROOT, "build", "dp_ab")
_NEW = os.path.join(_ROOT, "stringsearchlib_tpu_torch", "csrc", "dp_match.cu")
_T0 = time.perf_counter()


def _log(*a) -> None:
    print(f"[{time.perf_counter() - _T0:7.1f}s]", *a, flush=True)


def _parent_dp_match(root: str):
    """``ops.dp_match`` of the checkout at ``root``, imported as
    ``k5_parent.ops.dp_match`` so that it sits beside this package."""
    import importlib
    import importlib.util

    pkg = os.path.join(os.path.abspath(root), "stringsearchlib_tpu_torch")
    for name, path in (("k5_parent", pkg), ("k5_parent.ops", os.path.join(pkg, "ops"))):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(path, "__init__.py"), submodule_search_locations=[path])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return importlib.import_module("k5_parent.ops.dp_match")


def _loops(ins) -> list:
    """Innermost loops (backward branches spanning no other) of one
    function's SASS: start, end and instruction count."""
    import hits_ab

    spans = [(hits_ab._target(t), a) for a, t in ins
             if hits_ab._target(t) is not None and hits_ab._target(t) <= a]
    out = []
    for lo, hi in spans:
        if any(lo <= a and b <= hi and (a, b) != (lo, hi) for a, b in spans):
            continue
        out.append({"start": lo, "end": hi, "n": sum(1 for a, _ in ins if lo <= a <= hi)})
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout of another commit: its dp_match wrapper")
    ap.add_argument("--body", action="append", default=[],
                    help="NAME=PATH: another source with the package's entry")
    ap.add_argument("--rows2d", type=int, default=1_000_000)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=os.path.join(_BUILD, "dp_ab.json"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("dp_ab: no CUDA device")
    sys.path.insert(0, _ROOT)
    import numpy as np

    import chip_smoke as cs
    import hits_ab
    from stringsearchlib_tpu_torch.config import IndexConfig
    from stringsearchlib_tpu_torch.index import build as buildmod
    from stringsearchlib_tpu_torch.ops import dp_match as k5
    from stringsearchlib_tpu_torch.search import candidates
    from stringsearchlib_tpu_torch.search.engine import SearchEngine
    from stringsearchlib_tpu_torch.tools import bench

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    _log(card)
    dev = torch.device("cuda", 0)
    result: dict = {"card": card}

    srcs = {}  # body -> its CUDA source
    if args.parent:
        parent = _parent_dp_match(args.parent)
        srcs["parent"] = os.path.join(os.path.abspath(args.parent), "stringsearchlib_tpu_torch",
                                      "csrc", "dp_match.cu")
    for spec in args.body:
        name, _, path = spec.partition("=")
        srcs[name] = os.path.abspath(path)
    srcs["new"] = _NEW  # last: turns run parent, new, new, parent
    built = hits_ab._nvcc_jobs(srcs, _BUILD)
    P, I = ctypes.c_void_p, ctypes.c_int
    entries = {}
    for name in srcs:
        if name != "parent":
            fn = ctypes.CDLL(built[name]["so"]).dp_match_launch
            fn.argtypes = [P] * 6 + [I] * 8 + [P]
            entries[name] = fn
    sass = {}
    for name in srcs:
        regs = hits_ab._ptxas(built[name]["ptxas"])
        rep = {}
        for fn, ins in hits_ab._sass(built[name]["cubin"]).items():
            r = regs.get(fn, (None, None, None))
            loops = _loops(ins)
            info = {"registers": r[0], "spill_stores": r[1], "spill_loads": r[2],
                    "instructions": len(ins), "loops": loops}
            if name == "new" and "dp_match_kernelIhLi1ELi16E" in fn and loops:
                # the uint8 one-word instance's character loop: the largest
                # innermost loop, one step of each of the 16 queries
                info["per_query_step"] = max(lp["n"] for lp in loops) / 16
            rep[fn] = info
        sass[name] = rep
        _log("sass", name, json.dumps({f[-40:]: {k: v for k, v in d.items() if k != "loops"}
                                       for f, d in rep.items()}))
    result["sass"] = sass
    # the package body's whole SASS beside the readings, for reading by hand
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(os.path.splitext(args.out)[0] + ".new.sass", "w") as f:
        f.write(subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", built["new"]["cubin"]],
                               capture_output=True, text=True, check=True).stdout)

    def run(name, a):
        """One launch of body ``name`` on ``a``: the (B, N) int32 counts."""
        if name == "parent":
            return parent.dp_match(*a)
        tokens, lengths, qtok, qlens = a
        n, w = tokens.shape
        b, qp = qtok.shape
        out = torch.empty((b, n), dtype=torch.int32, device=dev)
        p = k5.plan(qp, n, b)
        scratch = out
        if p["nw"] == 0:
            scratch = torch.empty(2 * p["words"] * p["threads"], dtype=torch.int32, device=dev)
        err = entries[name](tokens.data_ptr(), lengths.data_ptr(), qtok.data_ptr(),
                            qlens.data_ptr(), out.data_ptr(), scratch.data_ptr(), n, w, b, qp,
                            tokens.element_size(), p["nw"], p["qc"], p["threads"],
                            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"body {name}: cuda error {err}")
        return out

    bad = []

    def time_shape(tag, a) -> dict:
        want = cs._k5_ref_rows(a)
        identical = {n: bool(torch.equal(run(n, a), want)) for n in srcs}
        identical["package_wrapper"] = bool(torch.equal(k5.dp_match(*a), want))
        bad.extend(f"{tag}/{n}" for n, ok in identical.items() if not ok)
        del want
        torch.cuda.empty_cache()
        turns = {n: [] for n in srcs}
        for n in list(srcs) + list(srcs)[::-1]:
            turns[n].append(cs._cuda_ms(lambda n=n: run(n, a), args.reps))
        device = {n: cs._queued_ms(lambda n=n: run(n, a), args.reps) for n in srcs}
        traced = [t1 - t0 for t0, t1, k in cs._device_spans(
            lambda: [run("new", a) for _ in range(args.reps)])[2] if "dp_match" in k]
        bound, by, cell = cs._dp_bound(*a)
        tokens, lengths, qtok, qlens = a
        res = {
            "shape": [int(qtok.shape[0]), int(tokens.shape[0]), int(tokens.shape[1])],
            "qp": int(qtok.shape[1]), "token_dtype": str(tokens.dtype).replace("torch.", ""),
            "mean_qlen": float(qlens.clamp(0, qtok.shape[1]).float().mean()),
            "mean_len": float(lengths.clamp(0, tokens.shape[1]).float().mean()),
            "plan": k5.plan(int(qtok.shape[1]), int(tokens.shape[0]), int(qtok.shape[0])),
            "identical": identical, "ms_turns": turns, "device_ms": device,
            "new_trace": {"kernels_kept": len(traced), "of": args.reps,
                          "mean_ms": sum(traced) / len(traced) / 1e3 if traced else None},
            "bound_ms": bound, "bound_by": by, "dp_cell_bound_ms": cell,
        }
        _log(tag, json.dumps(res))
        torch.cuda.empty_cache()
        return res

    shapes = {}
    # -- wide_100k_g3: the operands a batch hands the short tier's DP --------
    words = bench._wide_names(cs.N_WIDE)
    host = buildmod.build_index(words, 1, None, IndexConfig(wide=True, gram_size=3), device=dev)
    engine = SearchEngine(host)
    rng = random.Random(7)
    queries = [bench._mutate(rng, rng.choice(words)) for _ in range(cs.N_QUERIES_WIDE)]
    calls = cs._recorded_calls(candidates, "dp_match", lambda: engine.search_batch(
        queries, 0.3, 100, batch_bucket=512))
    if not calls:
        raise AssertionError("the wide g3 batch made no short-tier DP call")
    shapes["wide_g3_route"] = time_shape("wide_g3_route", calls[0])
    del engine, host, calls
    torch.cuda.empty_cache()

    # -- the 2-D index's long tier, the brute tier's queries -----------------
    rows = bench._product_names(args.rows2d, seed=5)
    descs = bench._rich_names(args.rows2d, seed=6)
    words2 = [x for kv in zip(rows, descs) for x in kv]
    del rows, descs
    weights = np.tile(np.array([1.0, 0.4]), args.rows2d)
    host2 = buildmod.build_index(words2, 2, weights, IndexConfig(), device=dev)
    engine2 = SearchEngine(host2)
    _, qtok, qlens = cs._brute_queries(engine2, words2, dev)
    di = host2.device
    long_args = (di.long_tokens, di.long_lengths)
    for b in (16, 4, 2, 1):
        shapes[f"brute_long_b{b}"] = time_shape(f"brute_long_b{b}",
                                                (*long_args, qtok[:b], qlens[:b]))
    del engine2, host2, di, long_args, words2
    torch.cuda.empty_cache()

    # -- chip_smoke's random cases ----------------------------------------------
    gen = torch.Generator().manual_seed(1234)
    for name, n, w, b, qp, wide in cs.K5_CASES:
        shapes[name] = time_shape(name, cs._k5_case(gen, n, w, b, qp, wide, dev))
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
