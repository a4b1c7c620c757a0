#!/usr/bin/env python3
"""Times bodies of the hit-count kernel (K1 / K2, ``csrc/bitmap_hits.cu``)
against each other on one CUDA card, and counts their SASS.

A body is a CUDA source with the package's C interface: the entries
``bitmap_hits_bmax_launch`` (K1) and ``bitmap_hits_launch`` (K2), or, given
as ``NAME=PATH@SYM``, ``SYM_bmax`` and ``SYM_hits`` with the same
arguments.  The package's own source is always the body ``new``; another,
such as an earlier commit's source (d82b9b2: the body before the
bit-sliced counters), is named on the command line:

    git show d82b9b2:stringsearchlib_tpu_torch/csrc/bitmap_hits.cu > dist/old.cu
    python3 hits_ab.py --body old=dist/old.cu

Every body is compiled with the package's nvcc flags (one process per
source, all started together) and once more to a cubin with ``-Xptxas -v``
for its registers, spills and SASS.  Each is held bit-identical to the
plain version on chip_smoke.py's random and edge cases, then on the real
tables: K1 on the headline's 10M-key bitmap table and K2 on the weighted
2-D index's packed sketch, at B = 256 and 512 with real queries' counts.
There the bodies run on the same compacted row lists in turns (every body,
then every body in reverse order), each turn the mean of ``--reps`` calls
timed with CUDA events, then in device time from calls queued behind a spin
kernel (``chip_smoke._queued_ms``; a torch.profiler trace's figure beside
it, which late in a long process can drop kernels and read "not
measured"), beside the bound and the listed (query, row) pairs.

The SASS count: in each kernel function, every loop (a backward branch)
with its instructions, 16-byte loads and LOP3s.  For the package's body it
reads the carry-save group loop (ten 16-byte loads: two of row indices,
eight of row slices) per 32-bit word per row, and, at the real tables'
lists, the instructions per word per listed row of a whole (query, tile):
the group loop and the higher-multiplicity loop at their trip counts plus
the rest of the slice count's code counted once (every tail block as if
taken: an upper estimate).

Writes every reading to ``--out`` (default ``build/hits_ab/hits_ab.json``)
and prints one JSON line per table and B.

``--library`` times the one PyTorch call that computes the same hits
instead (no other body): ``int_mm_counts`` (``torch._int_mm``, one call per
base-128 digit of the multiplicities) over the table's unpacked 0/1
incidence, held column-major as an (N, Gp) int8 tensor passed as ``.t()``
(``unpack_incidence``, untimed; freed before the next case), at each
kernel's own shapes: K1 on the 10M-key table at B = 256 and 512, K2 on the
2-D index's packed sketch at B = 256 and 512, K2w on the 10M-key table at
B = 32 on chip_smoke.py phase 29's first chunk, and K1 on rich_1m's table
at B = 256 where its unpacked operand fits.  Each case: the call's hits
equal to the kernel's, its ms per call (CUDA events), and device ms (calls
queued behind a spin kernel, the median of three rounds) beside the
kernel's, measured alike in the same process, and both bounds.

``--dense`` times the dense path's hit count instead, on the 10M-key
headline index: ``overlap.gather_hits`` (each row's distinct gram slots
expanded once, weighted by multiplicity) beside the plain count of one
posting list per window (K6's expansion of every repeat, a scatter-add of
ones: the dense path's layout before it counted distinct slots), equal
hits, ms per call and device ms, on the dense path's chunk of the
headline's queries (its first ``SearchEngine._batch_cap`` rows) and on the
same rows with each repeated slot dropped (a batch without repeats).  Then
one pasted document of 66,000-100,000 characters (``bench.documents``,
``random.Random(30)``: phase 30's first) at phase 30's threshold and
limit, each case after a line saying it starts (a run that the time limit
cuts still says how long the last one ran): the per-window count's
expansion, ``search_batch(..., mode="dense")`` and ``search_batch`` on its
route (``bitmap_scan``), each with its lanes, seconds to a synchronize,
peak device memory over the resident index, and the error where it ran
out of memory.

Usage:  python3 hits_ab.py [--body NAME=PATH[@SYM] ...] [--unchecked NAME ...]
                           [--keys N] [--rows2d N] [--reps N] [--out PATH]
        python3 hits_ab.py --library [--keys N] [--rows2d N] [--out PATH]
        python3 hits_ab.py --dense [--keys N] [--reps N] [--out PATH]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import random
import re
import subprocess
import sys
import time

_ROOT = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(_ROOT, "build", "hits_ab")
_CSRC = os.path.join(_ROOT, "stringsearchlib_tpu_torch", "csrc")
_NEW = os.path.join(_CSRC, "bitmap_hits.cu")
_T0 = time.perf_counter()


def _log(*a) -> None:
    print(f"[{time.perf_counter() - _T0:7.1f}s]", *a, flush=True)


def _nvcc_jobs(paths: dict, out_dir: str = _BUILD, kinds=("so", "cubin")) -> dict:
    """{tag: source} -> {tag: (so, cubin, ptxas log)} in ``out_dir`` (the
    ``kinds`` asked for), every compile started together; raises when one
    fails.  The package's csrc/ is on the include path, so a copy of one of
    its sources elsewhere finds the headers it includes."""
    nvcc = "/usr/local/cuda/bin/nvcc"
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-I", _CSRC]
    os.makedirs(out_dir, exist_ok=True)
    jobs = []
    for tag, src in paths.items():
        so = os.path.join(out_dir, f"lib{tag}.so")
        cubin = os.path.join(out_dir, f"{tag}.cubin")
        if "so" in kinds:
            jobs.append((tag, "so", so, subprocess.Popen(
                [nvcc, *flags, "-shared", "-Xcompiler", "-fPIC", "-o", so, src],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        if "cubin" in kinds:
            jobs.append((tag, "cubin", cubin, subprocess.Popen(
                [nvcc, *flags, "-Xptxas", "-v", "-cubin", "-o", cubin, src],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    out: dict = {tag: {} for tag in paths}
    for tag, kind, path, proc in jobs:
        stdout, stderr = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {kind} of {paths[tag]} failed:\n{stderr}")
        out[tag][kind] = path
        if kind == "cubin":
            out[tag]["ptxas"] = stdout + stderr
    return out


def _ptxas(log: str) -> dict:
    """{mangled function: (registers, spill store bytes, spill load bytes)}."""
    res = {}
    for m in re.finditer(
        r"Function properties for (\S+)\n\s+\d+ bytes stack frame, (\d+) bytes "
        r"spill stores, (\d+) bytes spill loads\nptxas info\s+: Used (\d+) registers",
        log,
    ):
        res[m.group(1)] = (int(m.group(4)), int(m.group(2)), int(m.group(3)))
    return res


def _sass(cubin: str) -> dict:
    """{function: [(address, instruction)]} from cuobjdump -sass."""
    text = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", cubin],
                          capture_output=True, text=True, check=True).stdout
    funcs: dict = {}
    cur = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s*(.*?);", line)
        if cur is not None and m:
            cur.append((int(m.group(1), 16), m.group(2).strip()))
    return funcs


def _opcode(ins: str) -> str:
    return re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0]


def _target(ins: str):
    """A branch's target address, else None."""
    m = re.search(r"BRA.*?0x([0-9a-f]+)", ins)
    return int(m.group(1), 16) if m else None


def _blocks(ins) -> list:
    """Basic blocks of a function: split at branch targets and after each
    branch; each {start, end, n, ld128, lop3, loads, loop}, ``loop`` when it
    ends in a branch back to its own start."""
    targets = {_target(t) for _, t in ins} - {None}
    blocks, cur = [], []
    for addr, t in ins:
        if addr in targets and cur:
            blocks.append(cur)
            cur = []
        cur.append((addr, t))
        if "BRA" in t or "EXIT" in t:
            blocks.append(cur)
            cur = []
    if cur:
        blocks.append(cur)
    out = []
    for b in blocks:
        body = [t for _, t in b]
        out.append({
            "start": b[0][0], "end": b[-1][0], "n": len(body),
            "ld128": sum(1 for t in body if "LDG" in t and ".128" in t),
            "loads": sum(1 for t in body if "LDG" in t),
            "lop3": sum(1 for t in body if _opcode(t) == "LOP3.LUT"),
            "loop": _target(body[-1]) == b[0][0],
        })
    return out


def _sass_report(tag: str, paths: dict) -> dict:
    """Per kernel function: registers, spills, instructions, and every
    innermost loop (a backward branch) that loads row slices, with its
    instructions per 32-bit word per row (its 16-byte loads, less two of row
    indices in a group of eight, are its rows)."""
    regs = _ptxas(paths["ptxas"])
    rep = {}
    for fn, ins in _sass(paths["cubin"]).items():
        r = regs.get(fn, (None, None, None))
        spans = [(_target(t), addr) for addr, t in ins
                 if _target(t) is not None and _target(t) <= addr]
        loops = []
        for lo, hi in spans:
            if any(lo <= a and b <= hi and (a, b) != (lo, hi) for a, b in spans):
                continue  # an outer loop
            body = [x for a, x in ins if lo <= a <= hi]
            ld128 = sum(1 for x in body if "LDG" in x and ".128" in x)
            if ld128:
                loops.append({"start": lo, "end": hi, "n": len(body), "ld128": ld128,
                              "per_word_row": len(body) / (4 * (ld128 - 2 * (ld128 >= 10)))})
        rep[fn] = {"registers": r[0], "spill_stores": r[1], "spill_loads": r[2],
                   "instructions": len(ins), "loops": loops}
    _log("sass", tag, json.dumps({f[-40:]: {k: v for k, v in d.items() if k != "loops"}
                                  for f, d in rep.items()}))
    return rep


def _per_word_row(ins, q) -> dict:
    """Instructions per 32-bit word per listed row of the package's body on
    ``q``'s lists.  Its SASS holds one path per slice count: a group loop
    (ten 16-byte loads), tails of 4, 2 and 1 rows (five, two and one 16-byte
    loads), a higher-multiplicity loop (one), then the bit transpose (the
    path's largest block without loads).  The paths are told apart by the
    group loop's LOP3 count, fewest first as NS = 4..7.  ``counting`` adds
    each query's taken blocks at their trip counts and the transpose;
    ``whole`` adds every other block of the path and the code before the
    first path once (an upper estimate: the list scan, the stores and the
    block maxima)."""
    blocks = _blocks(ins)
    groups = [i for i, b in enumerate(blocks) if b["loop"] and b["ld128"] == 10]
    if len(groups) != 4:
        return {"error": f"{len(groups)} group loops found, 4 expected"}
    paths = {}
    for k, g in enumerate(groups):
        span = blocks[g:groups[k + 1] if k + 1 < len(groups) else len(blocks)]
        part = {"group": blocks[g]["n"], "mult": 0, 4: 0, 2: 0, 1: 0, "transpose": 0}
        for b in span[1:]:
            if b["loop"] and b["ld128"] == 1:
                part["mult"] = b["n"]
            elif not b["loop"] and b["ld128"] in (5, 2, 1) and not part[{5: 4, 2: 2, 1: 1}[b["ld128"]]]:
                part[{5: 4, 2: 2, 1: 1}[b["ld128"]]] = b["n"]
            elif not b["loads"]:
                part["transpose"] = max(part["transpose"], b["n"])
        part["rest"] = sum(b["n"] for b in span) - sum(
            v for key, v in part.items() if key != "rest")
        paths[blocks[g]["lop3"]] = part
    paths = {4 + i: paths[k] for i, k in enumerate(sorted(paths))}
    prologue = sum(b["n"] for b in blocks[:groups[0]])
    counting = whole = words = 0
    for n1, nm, s in zip((q == 1).sum(1).tolist(), (q > 1).sum(1).tolist(), q.sum(1).tolist()):
        p = paths[4 if s <= 15 else 5 if s <= 31 else 6 if s <= 63 else 7]
        g8, r = divmod(int(n1), 8)
        c = (g8 * p["group"] + (r >= 4) * p[4] + (r % 4 >= 2) * p[2] + (r % 2) * p[1]
             + int(nm) * p["mult"] + p["transpose"])
        counting += c
        whole += c + p["rest"] + prologue
        words += 4 * (int(n1) + int(nm))
    return {"paths": paths, "prologue": prologue,
            "counting_per_word_row": counting / max(words, 1),
            "whole_per_word_row": whole / max(words, 1)}


def unpack_incidence(planes, chunk_bytes: int = 1 << 30):
    """A tile-major packed table (ntiles, Gp, 512) -> its 0/1 incidence as
    an (N, Gp) int8 tensor, N = ntiles * 4096 in term order (term j * 4096
    + p * 512 + k is bit p of byte k of tile j): ``.t()`` is the (Gp, N)
    column-major right operand of ``candidates.int_mm_counts``."""
    import torch

    ntiles, gp, blkb = planes.shape
    out = torch.empty((ntiles * 8 * blkb, gp), dtype=torch.int8, device=planes.device)
    shifts = torch.arange(8, dtype=torch.uint8, device=planes.device)[None, :, None, None]
    step = max(1, chunk_bytes // (8 * blkb * gp))
    for t0 in range(0, ntiles, step):
        t = planes[t0 : t0 + step].view(torch.uint8).permute(0, 2, 1)  # (nt, 512, Gp)
        bits = (t[:, None] >> shifts) & 1  # (nt, 8, 512, Gp)
        out[t0 * 8 * blkb : (t0 + t.shape[0]) * 8 * blkb] = bits.reshape(-1, gp).view(torch.int8)
        del t, bits
    return out


def _median(xs):
    xs = sorted(x for x in xs if x is not None)
    return xs[len(xs) // 2] if xs else None


def library_case(q, incidence, kernel, reps: int = 5) -> dict:
    """``int_mm_counts`` of (B, Gp) counts ``q`` over ``incidence`` ((N, Gp)
    int8 from ``unpack_incidence``, passed as ``.t()``) against the kernel
    call ``kernel()`` (its hits, or (hits, block maxima)) on the same
    counts: whether the call's int32 hits equal the kernel's, ms per call
    (CUDA events), device ms of both (calls queued behind a spin kernel, the
    median of three rounds), the call's ``_int_mm`` calls and bound (the
    operand read and the int32 hits written once, two int8 operations per
    multiply-add of each digit)."""
    import torch

    import chip_smoke as cs
    from stringsearchlib_tpu_torch.search import candidates as pc

    mat = incidence.t()
    vmax = int(q.max())
    calls = pc.INT_MM_CALLS
    got = pc.int_mm_counts(q, mat, vmax)
    per_call = pc.INT_MM_CALLS - calls
    want = kernel()
    want = want[0] if isinstance(want, tuple) else want
    step = 1 << 20
    equal = all(torch.equal(got[:, a : a + step], want[:, a : a + step].to(torch.int32))
                for a in range(0, got.shape[1], step))
    torch.cuda.synchronize()
    del got, want
    torch.cuda.empty_cache()
    b, (n, gp) = int(q.shape[0]), incidence.shape
    nbytes = n * gp + 4 * b * n + q.numel() * q.element_size()
    bound = cs._bound(nbytes, 2.0 * b * gp * n * per_call, cs.PEAK_INT8)
    return {
        "b": b, "gp": gp, "n": n, "vmax": vmax, "int_mm_calls": per_call,
        "equal_to_kernel": equal,
        "ms": cs._cuda_ms(lambda: pc.int_mm_counts(q, mat, vmax), reps),
        "device_ms": _median([cs._queued_ms(lambda: pc.int_mm_counts(q, mat, vmax), reps)
                              for _ in range(3)]),
        "kernel_ms": cs._cuda_ms(kernel, reps),
        "kernel_device_ms": _median([cs._queued_ms(kernel, reps) for _ in range(3)]),
        "bound_ms": bound[0], "bound_by": bound[1], "operand_bytes": n * gp,
    }


def library_main(args, card: str) -> dict:
    """``--library``: the cases of this script's docstring."""
    import torch

    import chip_smoke as cs
    from stringsearchlib_tpu_torch.config import IndexConfig
    from stringsearchlib_tpu_torch.index import build as buildmod
    from stringsearchlib_tpu_torch.ops import bitmap_matmul as bmm
    from stringsearchlib_tpu_torch.search.candidates import query_counts
    from stringsearchlib_tpu_torch.search.engine import SearchEngine
    from stringsearchlib_tpu_torch.search.sketch import bucket_of
    from stringsearchlib_tpu_torch.tools import bench

    import numpy as np

    dev = torch.device("cuda", 0)
    out: dict = {"card": card}

    def run(tag, table, qs, kernel_for):
        t0 = time.perf_counter()
        inc = unpack_incidence(table)
        torch.cuda.synchronize()
        unpack_s = time.perf_counter() - t0
        for name, q in qs.items():
            out[f"{tag}_{name}"] = {**library_case(q, inc, kernel_for(q, table), args.reps),
                                    "unpack_s": unpack_s}
            _log(tag, name, json.dumps(out[f"{tag}_{name}"]))
        del inc
        torch.cuda.empty_cache()

    # the headline's 10M-key table: K1 at B = 256 and 512, K2w at phase 29's chunk
    words = bench._product_names(args.keys, seed=2)
    host = buildmod.build_index(words, 1, None, IndexConfig(), device=dev)
    engine = SearchEngine(host)
    table = host.bitmap_tables(engine.BITMAP_BUDGET)[0]
    rng = random.Random(7)
    queries = [bench._mutate(rng, rng.choice(words)) for _ in range(cs.N_QUERIES)]
    items = [(pos, *engine._normalize_query(q), None) for pos, q in enumerate(queries)]
    slots = engine._prep_rows(items, 32)[3]
    gp = int(table.shape[1])
    run("k1", table, {f"b{b}": query_counts(torch.from_numpy(cs.np_tile(slots, b)).to(dev), gp)
                      for b in (256, 512)}, lambda q, t: lambda: bmm.bitmap_hits_bmax(q, t))
    scan = sum(cs._scan_queries(engine, words), [])
    calls = cs._wide_operands(engine, lambda: engine.search_batch(
        scan, cs.SCAN_THRESHOLD, cs.LIMIT, batch_bucket=512))
    # the wrapper reads one value back, so the kernel's side is its bare launches
    run("k2w", table, {f"b{int(calls[0][0].shape[0])}": calls[0][0]},
        lambda q, t: cs._wide_bare(q, t)[0])
    del engine, host, table, calls, words
    torch.cuda.empty_cache()

    # the 2-D index's packed sketch: K2 at B = 256 and 512
    rows2 = bench._product_names(args.rows2d, seed=5)
    descs = bench._rich_names(args.rows2d, seed=6)
    words2 = [x for kv in zip(rows2, descs) for x in kv]
    host2 = buildmod.build_index(words2, 2, np.tile(np.array([1.0, 0.4]), args.rows2d),
                                 IndexConfig(), device=dev)
    engine2 = SearchEngine(host2)
    sk = host2.sketch_tables(engine2.SKETCH_BUDGET)
    inc2, d_log2 = sk[0], int(sk[3])
    rng = random.Random(7)
    queries2 = [bench._mutate(rng, rng.choice(words2)) for _ in range(cs.N_QUERIES_2D)]
    items2 = [(pos, *engine2._normalize_query(q), None) for pos, q in enumerate(queries2)]
    slots2 = engine2._prep_rows(items2, 32)[3]
    run("k2", inc2, {f"b{b}": query_counts(
        bucket_of(torch.from_numpy(cs.np_tile(slots2, b)).to(dev), d_log2), 1 << d_log2)
        for b in (256, 512)}, lambda q, t: lambda: bmm.bitmap_hits(q, t))
    del engine2, host2, inc2, sk, words2, rows2, descs
    torch.cuda.empty_cache()

    # rich_1m's table (47,104 rows): K1 at B = 256, where the operand fits
    words3 = bench._rich_names(cs.N_1M, seed=1)
    host3 = buildmod.build_index(words3, 1, None, IndexConfig(), device=dev)
    engine3 = SearchEngine(host3)
    table3 = host3.bitmap_tables(engine3.BITMAP_BUDGET)[0]
    rng = random.Random(7)
    queries3 = [bench._mutate(rng, rng.choice(words3)) for _ in range(256)]
    items3 = [(pos, *engine3._normalize_query(q), None) for pos, q in enumerate(queries3)]
    slots3 = engine3._prep_rows(items3, 32)[3]
    need = table3.numel() * 8 + 256 * table3.shape[0] * 4096 * 5
    free = torch.cuda.mem_get_info()[0]
    if need < free:
        run("rich_1m_k1", table3, {"b256": query_counts(
            torch.from_numpy(slots3).to(dev), int(table3.shape[1]))},
            lambda q, t: lambda: bmm.bitmap_hits_bmax(q, t))
    else:
        out["rich_1m_k1_b256"] = {"not_measured": f"needs {need} bytes, {free} free"}
    return out


def _per_window_hits(gram_ptr, gram_terms, slots, n_long: int, s_cap: int):
    """The dense path's hit count with one posting list per window: every
    window's postings expanded (K6) into ``s_cap`` lanes, a scatter-add of
    ones."""
    import torch

    from stringsearchlib_tpu_torch.ops.vgather import expand_postings

    ids = expand_postings(gram_ptr, gram_terms, slots, s_cap, n_long).long()
    hits = torch.zeros((slots.shape[0], n_long + 1), dtype=torch.int32, device=slots.device)
    hits.scatter_add_(1, ids, torch.ones_like(ids, dtype=torch.int32))
    return hits[:, :n_long]


def _attempt(out: dict, name: str, fn, base: int, **info) -> None:
    """``out[name]``: ``fn()`` timed to a synchronize, its peak device memory
    over ``base`` and what it returns (a count of results or of terms hit),
    or the out-of-memory error."""
    import torch

    _log(json.dumps({"case": name, "start": True, **info}))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        n = fn()
        torch.cuda.synchronize()
        out[name] = {"s": time.perf_counter() - t0, "results": n,
                     "peak_over_index_bytes": torch.cuda.max_memory_allocated() - base, **info}
    except torch.cuda.OutOfMemoryError as e:  # the reading: this layout cannot serve it
        out[name] = {"s": time.perf_counter() - t0, "error": str(e).split("\n")[0], **info}
    _log(json.dumps({"case": name, **out[name]}))
    torch.cuda.empty_cache()


def dense_main(args, card: str) -> dict:
    """``--dense``: the cases of this script's docstring."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from stringsearchlib_tpu_torch.config import IndexConfig
    from stringsearchlib_tpu_torch.index import build as buildmod
    from stringsearchlib_tpu_torch.search.engine import SearchEngine, _next_pow2, slot_mass
    from stringsearchlib_tpu_torch.search.overlap import gather_hits
    from stringsearchlib_tpu_torch.tools import bench

    dev = torch.device("cuda", 0)
    out: dict = {"card": card}
    words = bench._product_names(args.keys, seed=2)
    engine = SearchEngine(buildmod.build_index(words, 1, None, IndexConfig(), device=dev))
    engine.host.bitmap_tables(engine.BITMAP_BUDGET)
    di, lens = engine.host.device, engine.host.host_posting_lens

    rng = random.Random(7)
    queries = [bench._mutate(rng, rng.choice(words)) for _ in range(cs.N_QUERIES)]
    items = [(pos, *engine._normalize_query(q), None) for pos, q in enumerate(queries)]
    items = items[: engine._batch_cap(len(items))]  # the dense path's chunk
    slots = engine._prep_rows(items, 32)[3][: len(items)]
    srt = np.sort(slots, axis=1)
    dup = np.zeros(srt.shape, bool)
    dup[:, 1:] = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
    for name, s in (("headline", slots), ("headline_no_repeats", np.where(dup, -1, srt))):
        full, distinct = slot_mass(lens, s)
        st = torch.from_numpy(np.ascontiguousarray(s)).to(dev)
        s_cap, d_cap = _next_pow2(max(full, 1), 1024), _next_pow2(max(distinct, 1), 1024)

        def new(st=st, d_cap=d_cap):
            return gather_hits(di.gram_ptr, di.gram_terms, st, di.n_long, d_cap)

        def old(st=st, s_cap=s_cap):
            return _per_window_hits(di.gram_ptr, di.gram_terms, st, di.n_long, s_cap)

        s_np = np.sort(s, axis=1)
        out[name] = {
            "rows": int(s.shape[0]),
            "rows_with_repeats": int(((s_np[:, 1:] == s_np[:, :-1]) & (s_np[:, 1:] >= 0))
                                     .any(1).sum()),
            "s_cap": s_cap, "d_cap": d_cap, "equal": bool(torch.equal(new(), old())),
            "ms": cs._cuda_ms(new, args.reps),
            "device_ms": _median([cs._queued_ms(new, args.reps) for _ in range(3)]),
            "per_window_ms": cs._cuda_ms(old, args.reps),
            "per_window_device_ms": _median([cs._queued_ms(old, args.reps) for _ in range(3)]),
        }
        _log(name, json.dumps(out[name]))
        torch.cuda.empty_cache()

    doc = bench.documents(words, 1, random.Random(30))[0]
    item = (0, *engine._normalize_query(doc), None)
    qp = _next_pow2(item[2], 16)
    b, _, _, slots, nqg, _, s_cap, d_cap = engine._prep_rows([item], qp)
    st = torch.from_numpy(slots).to(dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    out["document"] = {"chars": len(doc), "windows": int(nqg[0]), "qp": qp, "rows": b,
                       "s_cap": s_cap, "d_cap": d_cap, "resident_bytes": base}
    _log(json.dumps(out["document"]))

    def search(**kw):
        return len(engine.search_batch([doc], cs.SCAN_DOC_THRESHOLD, cs.LIMIT, **kw)[0][0])

    _attempt(out, "document_per_window_hits", lambda: int(_per_window_hits(
        di.gram_ptr, di.gram_terms, st, di.n_long, s_cap).count_nonzero()), base,
        lanes=b * s_cap)
    _attempt(out, "document_dense", lambda: search(mode="dense"), base, lanes=b * d_cap)
    search()  # the route's warm-up
    _attempt(out, "document_route", search, base)
    out["document_route"]["routing"] = dict(engine.last_routing)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--body", action="append", default=[],
                    help="NAME=PATH[@SYM]: another body to compare")
    ap.add_argument("--unchecked", action="append", default=[],
                    help="NAME: a body timed whose outputs are not expected to "
                         "match (a memory-only probe)")
    ap.add_argument("--keys", type=int, default=10_000_000)
    ap.add_argument("--rows2d", type=int, default=1_000_000)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=os.path.join(_BUILD, "hits_ab.json"))
    ap.add_argument("--library", action="store_true",
                    help="time int_mm_counts at each kernel's shapes instead")
    ap.add_argument("--dense", action="store_true",
                    help="time the dense path's hit count and one document instead")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("hits_ab: no CUDA device")
    sys.path.insert(0, _ROOT)
    import numpy as np

    import chip_smoke as cs
    from stringsearchlib_tpu_torch.config import IndexConfig
    from stringsearchlib_tpu_torch.index import build as buildmod
    from stringsearchlib_tpu_torch.ops import bitmap_matmul as bmm
    from stringsearchlib_tpu_torch.search.candidates import query_counts
    from stringsearchlib_tpu_torch.search.engine import SearchEngine
    from stringsearchlib_tpu_torch.search.sketch import bucket_of
    from stringsearchlib_tpu_torch.tools import bench

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    _log(card)
    if args.library or args.dense:
        result = (library_main if args.library else dense_main)(args, card)
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1, default=str)
        ok = all(v.get("equal_to_kernel", True) and v.get("equal", True)
                 for v in result.values() if isinstance(v, dict))
        print(json.dumps({"ok": ok, "card": card}))
        if not ok:
            raise SystemExit(1)
        return
    dev = torch.device("cuda", 0)
    result: dict = {"card": card}

    bodies = {}
    for spec in args.body:
        name, _, rest = spec.partition("=")
        path, _, sym = rest.partition("@")
        bodies[name] = (os.path.abspath(path), sym or None)
    bodies["new"] = (_NEW, None)  # last: turns run old, new, new, old
    srcs = {}
    for name, (path, _) in bodies.items():
        srcs.setdefault(path, f"src{len(srcs)}")
    built = _nvcc_jobs({tag: path for path, tag in srcs.items()})
    handles = {tag: ctypes.CDLL(b["so"]) for tag, b in built.items()}
    P, I = ctypes.c_void_p, ctypes.c_int
    fns = {}
    for name, (path, sym) in bodies.items():
        h = handles[srcs[path]]
        k1 = getattr(h, f"{sym}_bmax" if sym else "bitmap_hits_bmax_launch")
        k2 = getattr(h, f"{sym}_hits" if sym else "bitmap_hits_launch")
        k1.argtypes, k2.argtypes = [P] * 5 + [I] * 4 + [P], [P] * 4 + [I] * 4 + [P]
        fns[name] = (k1, k2)
    sass = {tag: _sass_report(tag, built[tag]) for tag in built}
    result["sass"] = {path: sass[tag] for path, tag in srcs.items()}
    new_ins = _sass(built[srcs[_NEW]]["cubin"])
    _log("bodies", ",".join(bodies))

    def run(name, rows, mults, planes, bmax):
        """One launch of body ``name`` on compacted lists; its outputs."""
        b, nt, gp = rows.shape[0], planes.shape[0], planes.shape[1]
        hits = torch.empty((b, nt * 4096), dtype=torch.int8, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        if bmax:
            bm = torch.empty((b, nt * 32), dtype=torch.int8, device=dev)
            err = fns[name][0](planes.data_ptr(), rows.data_ptr(), mults.data_ptr(),
                               hits.data_ptr(), bm.data_ptr(), b, gp, nt, rows.shape[1], stream)
            out = (hits, bm)
        else:
            err = fns[name][1](planes.data_ptr(), rows.data_ptr(), mults.data_ptr(),
                               hits.data_ptr(), b, gp, nt, rows.shape[1], stream)
            out = hits
        if err:
            raise RuntimeError(f"body {name}: cuda error {err}")
        return out

    def same(got, want) -> bool:
        if isinstance(got, tuple):
            return all(cs._max_abs_err(g, w) == 0 for g, w in zip(got, want))
        return cs._max_abs_err(got, want) == 0

    # -- every body against the plain version, random and edge cases ---------
    gen = torch.Generator().manual_seed(1234)
    cases = [(f"rand_gp{gp}_b{b}_s{s}",) + cs._random_case(gen, b, gp, 3, s, dev)
             for gp, b, s in ((128, 16, 31), (2816, 256, 127), (8192, 64, 127))]
    cases += cs._edge_cases(gen, dev)
    bad = []
    for case, planes, q in cases:
        rows, mults = bmm._compact_qcnt(q)
        for bmax in (True, False):
            want = bmm.bitmap_hits_bmax_ref(q, planes) if bmax else bmm.bitmap_hits_ref(q, planes)
            for name in bodies:
                if name not in args.unchecked and not same(
                        run(name, rows, mults, planes, bmax), want):
                    bad.append(f"{case}/{'k1' if bmax else 'k2'}/{name}")
    result["cases"] = len(cases) * 2 * len(bodies)
    result["cases_failed"] = bad
    _log("cases", result["cases"], "failed", bad)
    del cases

    def time_table(tag, planes, qs, bmax):
        res = {}
        for b, q in qs.items():
            rows, mults = bmm._compact_qcnt(q)
            want = (bmm.bitmap_hits_bmax_ref(q, planes, chunk_tiles=16) if bmax
                    else bmm.bitmap_hits_ref(q, planes, chunk_tiles=16))
            identical = {n: same(run(n, rows, mults, planes, bmax), want) for n in bodies}
            wrapper = bmm.bitmap_hits_bmax(q, planes) if bmax else bmm.bitmap_hits(q, planes)
            identical["package_wrapper"] = same(wrapper, want)
            del want, wrapper
            torch.cuda.empty_cache()
            turns = {n: [] for n in bodies}
            for n in list(bodies) + list(bodies)[::-1]:
                turns[n].append(cs._cuda_ms(lambda: run(n, rows, mults, planes, bmax), args.reps))
            device = {n: cs._queued_ms(lambda: run(n, rows, mults, planes, bmax), args.reps)
                      for n in bodies}
            traced = {n: cs._device_ms(lambda: run(n, rows, mults, planes, bmax), args.reps)
                      for n in bodies}
            bound = cs._hits_bound(q, int(planes.shape[0]), bmax=bmax)
            nz = q != 0
            res[b] = {
                "listed_pairs": int(nz.sum()), "distinct_rows": int(nz.any(0).sum()),
                "sum_mean": float(q.sum(1).float().mean()), "sum_max": int(q.sum(1).max()),
                "mult_above_1_pairs": int((q > 1).sum()), "max_mult": int(q.max()),
                "identical": identical, "ms_turns": turns, "device_ms": device,
                "trace_device_ms": traced,
                "bound_ms": bound[0], "bound_by": bound[1],
                "issue": cs._hits_issue(q, int(planes.shape[0])),
                "sass_new": {fn[-24:]: _per_word_row(ins, q) for fn, ins in new_ins.items()
                             if "wide" not in fn and "add_plane" not in fn},
            }
            _log(tag, b, json.dumps(res[b]))
            torch.cuda.empty_cache()
        return res

    # -- K1: the headline's 10M-key table ---------------------------------------
    words = bench._product_names(args.keys, seed=2)
    host = buildmod.build_index(words, 1, None, IndexConfig(), device=dev)
    engine = SearchEngine(host)
    table = host.bitmap_tables(engine.BITMAP_BUDGET)[0]
    _log("10M table", tuple(table.shape))
    rng = random.Random(7)
    queries = [bench._mutate(rng, rng.choice(words)) for _ in range(cs.N_QUERIES)]
    items = [(pos, *engine._normalize_query(q), None) for pos, q in enumerate(queries)]
    slots = engine._prep_rows(items, 32)[3]
    gp = int(table.shape[1])
    qs = {b: query_counts(torch.from_numpy(cs.np_tile(slots, b)).to(dev), gp) for b in (256, 512)}
    result["k1"] = time_table("k1", table, qs, True)
    del engine, host, table, qs, words
    torch.cuda.empty_cache()

    # -- K2: the weighted 2-D index's packed sketch ------------------------------
    rows2 = bench._product_names(args.rows2d, seed=5)
    descs = bench._rich_names(args.rows2d, seed=6)
    words2 = [x for kv in zip(rows2, descs) for x in kv]
    weights = np.tile(np.array([1.0, 0.4]), args.rows2d)
    host2 = buildmod.build_index(words2, 2, weights, IndexConfig(), device=dev)
    engine2 = SearchEngine(host2)
    sk = host2.sketch_tables(engine2.SKETCH_BUDGET)
    inc, d_log2 = sk[0], int(sk[3])
    _log("sketch table", tuple(inc.shape))
    rng = random.Random(7)
    queries2 = [bench._mutate(rng, rng.choice(words2)) for _ in range(cs.N_QUERIES_2D)]
    items2 = [(pos, *engine2._normalize_query(q), None) for pos, q in enumerate(queries2)]
    slots2 = engine2._prep_rows(items2, 32)[3]
    qs2 = {b: query_counts(bucket_of(torch.from_numpy(cs.np_tile(slots2, b)).to(dev), d_log2),
                           1 << d_log2) for b in (256, 512)}
    result["k2"] = time_table("k2", inc, qs2, False)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1, default=str)
    ok = not bad and all(v for k in ("k1", "k2") for r in result[k].values()
                         for n, v in r["identical"].items() if n not in args.unchecked)
    print(json.dumps({"ok": ok, "card": card}))
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
