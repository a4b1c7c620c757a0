#!/usr/bin/env python3
"""Times two kernels of an earlier checkout of the port against this tree's,
in turns, on one CUDA card: K6's gather (``ops.vgather.gather_tables``) and
the K1 probes' epilogues (``ops.probes``: P8 int16 and int32 and P9's six
variants; the int32 epilogue is both P8 i32 and P9 rawi32), with K1
(``ops.bitmap_matmul.bitmap_hits_bmax``) beside them.

The earlier checkout is a directory that holds its
``stringsearchlib_tpu_torch``, such as a commit unpacked with git archive
into a directory .gitignore lists:

    mkdir -p dist/parent && git archive HEAD~1 | tar -x -C dist/parent
    python3 gather_store_ab.py --parent dist/parent

Its package is imported under another name, so both run in one process,
each with its own wrappers and with its kernels built from its own sources
(into its checkout's ``build/kernels/``; the two builds start together).
On every case the two sides' outputs are held bit-identical to each other
and to the plain version (the probes' on their first 16 queries), then the
sides are timed in turns (every side in order, then in reverse): per call
with CUDA events (host work included, K6 only) and in device time
(``tools.common.queued_ms``: calls queued behind a spin kernel).

K6: a random int32 table of ``--table-words`` words (37.6M, the 2-D index's
postings) and a float32 one; 256 x 65,536 sorted int64 indices (the random
shape), 256 x 1,024 (the wide g3 route's old-path shape), 8 x 2^20
unsorted, 64 x 65,536 int32 over both tables; ``torch.take`` on the
clamped indices beside them (one table, no fill), the bound
(``chip_smoke._gather_bound``), and host microseconds per call at the
route shape (time.perf_counter over 3,000 calls a side, in turns).

Probes: the headline's ``--keys``-key table (``tools.common.headline``) in
the reference's row-major layout, the first 256 queries' counts and those
256 twice (B = 512), as chip_smoke.py's probe phase takes them; all the
sides of one B in one set of turns, so each variant is read in turns with
every other.  Registers and spills of both sides' probe and gather
instances from ``nvcc -Xptxas -v`` (``hits_ab._nvcc_jobs``).

Writes every reading to ``--out`` (default
``build/gather_store_ab/ab.json``) and prints one JSON line per case and a
last line ``{"ok": ..., "card": ...}``; exits 1 when any output differs.

Usage:  python3 gather_store_ab.py --parent DIR [--keys N] [--table-words N]
                                   [--reps N] [--out PATH]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import importlib
import importlib.util
import json
import os
import re
import sys
import time

_ROOT = os.path.dirname(os.path.abspath(__file__))
_PKG = "stringsearchlib_tpu_torch"
_T0 = time.perf_counter()


def _log(*a) -> None:
    print(f"[{time.perf_counter() - _T0:7.1f}s]", *a, flush=True)


def _load(root: str, name: str):
    """The port's package under ``root``, imported as ``name``."""
    pkg = os.path.join(os.path.abspath(root), _PKG)
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _in_turns(sides: dict, timer) -> dict:
    """``timer`` on every side ({name: fn}) in order, then in reverse:
    {name: its two readings, their mean}."""
    names = list(sides)
    res = {n: [] for n in names}
    for n in names + names[::-1]:
        res[n].append(timer(sides[n]))
    return {n: {"turns": v, "mean": _mean(v)} for n, v in res.items()}


def _mean(xs):
    xs = [x for x in xs if x is not None]
    return sum(xs) / len(xs) if xs else None


def _ptxas(hits_ab, srcs: dict) -> dict:
    """{side: {source: {instance: registers and spills}}} from ptxas."""
    jobs = {f"{side}_{name}": os.path.join(root, _PKG, "csrc", f"{name}.cu")
            for side, root in srcs.items() for name in ("probe_hits", "gather_tables")}
    logs = hits_ab._nvcc_jobs(jobs, os.path.join(_ROOT, "build", "gather_store_ab"),
                              ("cubin",))
    out = {}
    for tag, built in logs.items():
        side, name = tag.split("_", 1)
        inst = {}
        for fn, (r, st, ld) in hits_ab._ptxas(built["ptxas"]).items():
            m = (re.search(r"probe_hits_kernelILi(\d+)ELi(\d+)E", fn)
                 or re.search(r"(gather_tables_kernel\w*?E|expand_postings_kernel|part_\w+?_kernel)",
                              fn))
            key = (f"epilogue {m.group(1)} qpb{m.group(2)}" if m and m.lastindex == 2
                   else m.group(1) if m else fn)
            inst[key] = {"registers": r, "spill_stores": st, "spill_loads": ld}
        out.setdefault(side, {})[name] = inst
    return out


def _k6(sides_mod, dev, t_len: int, reps: int, cs) -> dict:
    """K6's cases: each side bit-identical to the plain version, then
    per call and device ms in turns with ``torch.take``."""
    import torch

    tree = sides_mod["tree"]
    gen = torch.Generator(device=dev).manual_seed(66)
    itab = torch.randint(-2**31, 2**31 - 1, (t_len,), generator=gen, device=dev,
                         dtype=torch.int32)
    ftab = torch.randn(t_len, generator=gen, device=dev)
    out = {}
    for name, b, c, ordered, dt, two in (
        ("b256_c65536_sorted_int64", 256, 1 << 16, True, torch.int64, False),
        ("b256_c1024_sorted_int64", 256, 1 << 10, True, torch.int64, False),
        ("b8_c1048576_unsorted_int64", 8, 1 << 20, False, torch.int64, False),
        ("b64_c65536_int32_two_tables", 64, 1 << 16, False, torch.int32, True),
    ):
        idx = torch.randint(-1000, t_len + 1000, (b, c), generator=gen, device=dev)
        if ordered:
            idx = idx.sort(dim=1).values
        idx = idx.to(dt).contiguous()
        tables = [itab, ftab] if two else [itab]
        fills = [-(1 << 31), float("nan")] if two else [t_len]
        want = tree.gather_tables_ref(idx, tables, fills)
        idc = idx.clamp(0, t_len - 1).long()
        sides = {s: (lambda m=m: m.gather_tables(idx, tables, fills))
                 for s, m in sides_mod.items()}
        identical = {}
        for s, fn in sides.items():
            got = fn()
            identical[s] = all(g.dtype == w.dtype and torch.equal(g.view(torch.int32),
                                                                  w.view(torch.int32))
                               for g, w in zip(got, want))
            del got
        sides["take"] = lambda: torch.take(itab, idc)
        del want
        bound = cs._gather_bound(idx, t_len, len(tables))
        res = {"shape": [b, c], "index_dtype": str(dt).replace("torch.", ""),
               "tables": len(tables), "table_len": t_len, "identical": identical,
               "ms": _in_turns(sides, lambda f: cs._cuda_ms(f, reps)),
               "device_ms": _in_turns(sides, lambda f: cs._queued_ms(f, reps)),
               "bound_ms": bound[0], "bound_by": bound[1]}
        if name == "b256_c1024_sorted_int64":
            def per_call_us(f, n=3000):
                f()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(n):
                    f()
                us = (time.perf_counter() - t0) / n * 1e6
                torch.cuda.synchronize()
                return us

            res["host_us"] = _in_turns(sides, per_call_us)
        out[name] = res
        _log("k6", name, json.dumps(res))
        del idx, idc, sides
        torch.cuda.empty_cache()
    return out


def _probes(mods: dict, dev, keys: int, reps: int) -> dict:
    """The probes' and K1's cases on the headline table, B = 256 and 512."""
    import torch

    tree = mods["tree"]
    table, slots = tree["common"].headline(keys, 256, dev)
    rm = tree["bmm"].from_tile_major(table).contiguous()
    q = tree["common"].counts(slots, int(table.shape[1]), dev)
    _log("headline table", tuple(table.shape), "row-major", tuple(rm.shape))
    out = {"table_shape": list(rm.shape), "max_windows": int(q.sum(1).max())}
    for b, qq in ((256, q), (512, torch.cat([q, q]))):
        cases = {"P8_i16": lambda p, qq=qq: p.raw_hits(qq, rm, i16=True),
                 "P8_i32": lambda p, qq=qq: p.raw_hits(qq, rm, i16=False)}
        if b == 256:
            cases.update({f"P9_{v}": (lambda p, v=v: p.bisect_run(q, rm, variant=v))
                          for v in tree["probes"].BISECT_VARIANTS})
        cases["K1"] = "k1"
        refs = {"P8_i16": lambda p: p.raw_hits_ref(qq[:16], rm, i16=True),
                "P8_i32": lambda p: p.raw_hits_ref(qq[:16], rm, i16=False)}
        refs.update({f"P9_{v}": (lambda p, v=v: p.bisect_ref(qq[:16], rm, variant=v))
                     for v in tree["probes"].BISECT_VARIANTS})
        sides, identical = {}, {}
        for case, call in cases.items():
            for s, m in mods.items():
                if call == "k1":
                    fn = (lambda m=m, qq=qq: m["bmm"].bitmap_hits_bmax(qq, table))
                else:
                    fn = (lambda m=m, call=call: call(m["probes"]))
                sides[f"{case}/{s}"] = fn
            got = {s: sides[f"{case}/{s}"]() for s in mods}
            same = all(torch.equal(a, c) for a, c in zip(
                *[g if isinstance(g, tuple) else (g,) for g in got.values()]))
            if case in refs:
                want = refs[case](tree["probes"])
                same = same and all(torch.equal(g[:16], want) for g in got.values())
                del want
            identical[case] = same
            del got
            torch.cuda.empty_cache()
        dev_ms = _in_turns(sides, lambda f: tree["common"].queued_ms(f, reps))
        out[f"b{b}"] = {"identical": identical, "device_ms": dev_ms}
        _log("probes", b, json.dumps(out[f"b{b}"]))
        del sides
        torch.cuda.empty_cache()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="a checkout of an earlier commit (holds stringsearchlib_tpu_torch)")
    ap.add_argument("--keys", type=int, default=10_000_000)
    ap.add_argument("--table-words", type=int, default=37_600_000)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=os.path.join(_ROOT, "build", "gather_store_ab", "ab.json"))
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(args.parent, _PKG)):
        raise SystemExit(f"gather_store_ab: no {_PKG} under {args.parent}")

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("gather_store_ab: no CUDA device")
    sys.path.insert(0, _ROOT)
    import chip_smoke as cs
    import hits_ab

    _load(args.parent, "parent_port")
    mods = {}
    for side, pkg in (("parent", "parent_port"), ("tree", _PKG)):
        mods[side] = {k: importlib.import_module(f"{pkg}.{mod}") for k, mod in (
            ("kernels", "ops.kernels"), ("vgather", "ops.vgather"), ("probes", "ops.probes"),
            ("bmm", "ops.bitmap_matmul"), ("common", "tools.common"))}
    dev, card = mods["tree"]["common"].card()
    _log(card)
    result: dict = {"card": card, "parent": os.path.abspath(args.parent)}
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        ptxas = pool.submit(_ptxas, hits_ab, {"parent": args.parent, "tree": _ROOT})
        builds = [pool.submit(m["kernels"].build_kernels) for m in mods.values()]
        for f in builds:
            f.result()
        result["ptxas"] = ptxas.result()
    _log("built", json.dumps(result["ptxas"]))
    result["k6"] = _k6({s: m["vgather"] for s, m in mods.items()}, dev,
                       args.table_words, 10, cs)
    torch.cuda.empty_cache()
    result["probes"] = _probes(mods, dev, args.keys, args.reps)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1, default=str)
    ok = (all(all(c["identical"].values()) for c in result["k6"].values())
          and all(all(v["identical"].values()) for k, v in result["probes"].items()
                  if k.startswith("b")))
    print(json.dumps({"ok": ok, "card": card}))
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
