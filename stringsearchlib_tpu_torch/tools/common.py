"""Shared pieces of the probe tools: the card, timing, bounds, the headline
inputs, and one probe case checked against its plain version and timed.

Times come from CUDA events (``cuda_ms``: per call, the host's launch work
included), from calls queued behind a spin kernel (``queued_ms``: the
device's work back to back) and from such calls each after an L2 flush
(``flushed_ms``: each call from a cold L2).  Bounds divide the bytes a
function must move by the H100's published 3.35 TB/s and its operations by
the published peak for their type (NVIDIA H100 SXM data sheet, dense, at
700 W).
"""

from __future__ import annotations

import dataclasses
import json
import random
import subprocess
from typing import Callable, Optional

import torch

PEAK_BYTES = 3.35e12
PEAK_INT8 = 1979e12
PEAK_BF16 = 989e12
# cycles of the spin kernel that queued calls wait behind (~50 ms at the
# H100's 1.98 GHz): far longer than the host takes to enqueue them
SPIN_CYCLES = 100_000_000
# above this, a probe's plain version is compared on its first query rows
PLAIN_WHOLE_MS = 2000.0
PLAIN_HEAD_ROWS = 64


def card():
    """(device, nvidia-smi's "name, power limit") of CUDA card 0; raises
    SystemExit without a card: the probes have no CPU form worth timing."""
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    return dev, smi


def emit(**fields) -> None:
    """One JSON line on stdout."""
    print(json.dumps(fields, default=str), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, after one warm-up,
    timed with CUDA events."""
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


def queued_ms(fn, reps: int = 20) -> Optional[float]:
    """Device milliseconds per call: ``reps`` calls enqueued while a spin
    kernel holds the card, timed with CUDA events from the spin's end to the
    last call's end, so no host time between launches counts and what
    remains is the device's work, back to back.  It needs no profiler: late
    in a long process torch.profiler drops the first kernels of a trace and
    can misstate the rest.  None (not measured) when the spin ended before
    the host had enqueued every call, or when ``fn`` waits for the device."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    late = start.query()  # the spin had ended: host gaps would count
    torch.cuda.synchronize()
    return None if late else start.elapsed_time(end) / reps


def flushed_ms(fn, reps: int = 10) -> Optional[float]:
    """Device milliseconds per call with the L2 flushed before each call:
    ``reps`` calls enqueued behind a spin kernel, each after a write of
    twice the L2's bytes (which evicts what the last call left there),
    each call timed alone with CUDA events and the times averaged, so no
    host time and no flush counts.  None (not measured) when the spin ended
    before the host had enqueued every call."""
    l2 = torch.cuda.get_device_properties(torch.cuda.current_device()).L2_cache_size
    flush = torch.empty(2 * l2, dtype=torch.int8, device="cuda")
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda._sleep(SPIN_CYCLES)
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    late = events[0][0].query()
    torch.cuda.synchronize()
    del flush
    if late:
        return None
    return sum(s.elapsed_time(e) for s, e in events) / reps


def timed_once(fn):
    """(fn's result, its milliseconds) for one call, CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def bound(nbytes: float, ops: float = 0.0, peak_ops: Optional[float] = None):
    """The least time the card could take (ms) and what bounds it: the
    larger of ``nbytes`` over the HBM rate and ``ops`` over ``peak_ops``."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / peak_ops * 1e3 if ops else 0.0
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def hits_bound(q, ntiles: int, out_bytes: int):
    """A K1 probe on ``q`` (B, Gp) counts over ``ntiles`` layout tiles: the
    listed rows of the table read once, the counts, the output written once;
    two int8 operations per listed (query, row, term), as K1's bound."""
    rows = int((q != 0).any(0).sum())
    nbytes = rows * ntiles * 512 + q.numel() * q.element_size() + out_bytes
    ops = 2 * int((q != 0).sum()) * ntiles * 4096
    return nbytes, ops


def max_abs_err(a, b, rows: int = 16) -> int:
    """Largest |a - b| over two equal-shape integer tensors, widened to
    int64 ``rows`` slices of the first axis at a time."""
    if a.shape != b.shape:
        raise AssertionError(f"shapes differ: {tuple(a.shape)} against {tuple(b.shape)}")
    err = 0
    for r in range(0, a.shape[0], rows):
        d = a[r : r + rows].to(torch.int64) - b[r : r + rows].to(torch.int64)
        err = max(err, int(d.abs().max()) if d.numel() else 0)
    return err


@dataclasses.dataclass
class Case:
    """One probe call at a shape: its kernel, its plain version (``plain(
    rows)`` computes the first ``rows`` queries' output, all of it for
    None), the bytes and operations of its bound, and the PyTorch call that
    computes the same function, where one does."""

    probe: str
    name: str
    kernel: Callable
    plain: Callable
    nbytes: float
    ops: float = 0.0
    peak_ops: Optional[float] = None
    query_axis: Optional[int] = None  # the output's query axis, if any
    library: Optional[Callable] = None


def measure(case: Case, reps: int = 5) -> dict:
    """``case``'s kernel against its plain version (the whole output, or its
    first PLAIN_HEAD_ROWS query rows when the whole would take the plain
    version past PLAIN_WHOLE_MS), then timed: per call and queued, the plain
    version once, the library call, beside the bound.  Raises when the
    kernel's output differs."""
    out = case.kernel()
    b = out.shape[case.query_axis] if case.query_axis is not None else 0
    rows = None
    if case.query_axis is not None and b > PLAIN_HEAD_ROWS:
        head, head_ms = timed_once(lambda: case.plain(PLAIN_HEAD_ROWS))
        del head
        if head_ms * b / PLAIN_HEAD_ROWS > PLAIN_WHOLE_MS:
            rows = PLAIN_HEAD_ROWS
    want, plain_ms = timed_once(lambda: case.plain(rows))
    got = out if rows is None else out.narrow(case.query_axis, 0, rows)
    err = max_abs_err(got, want)
    identical = err == 0 and got.dtype == want.dtype and torch.equal(got, want)
    del out, got, want
    torch.cuda.empty_cache()
    if not identical:
        raise AssertionError(f"{case.probe} {case.name}: the kernel differs from "
                             f"its plain version, max_abs_err {err}")
    ms = cuda_ms(case.kernel, reps)
    device_ms = queued_ms(case.kernel, reps)
    library_ms = cuda_ms(case.library, reps) if case.library is not None else None
    bound_ms, bound_by = bound(case.nbytes, case.ops, case.peak_ops)
    torch.cuda.empty_cache()
    return {
        "probe": case.probe, "name": case.name, "max_abs_err": err,
        "compared_rows": rows or "all", "ms": ms, "device_ms": device_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
        "gb_per_s": case.nbytes / (device_ms or ms) / 1e6,
    }


def headline(n_keys: int, bsz: int, dev):
    """The headline's resident table and ``bsz`` queries' gram slots:
    ``tools.bench._product_names(n_keys, seed=2)`` built by the port's
    ``build_index``, queries ``tools.bench._mutate`` under ``random.Random(7)``,
    slots from the engine's ``_prep_rows`` (32 query characters), as the
    reference's probe tools make them.  Returns (tile-major table, (bsz,
    30) int32 slots)."""
    from ..config import IndexConfig
    from ..index.build import build_index
    from ..search.engine import SearchEngine
    from . import bench

    words = bench._product_names(n_keys, seed=2)
    rng = random.Random(7)
    queries = [bench._mutate(rng, rng.choice(words)) for _ in range(bsz)]
    host = build_index(words, 1, None, IndexConfig(), device=dev)
    engine = SearchEngine(host)
    bm = host.bitmap_tables(engine.BITMAP_BUDGET)
    if bm is None:
        raise RuntimeError("the packed table is over BITMAP_BUDGET")
    items = [(pos, *engine._normalize_query(q), None) for pos, q in enumerate(queries)]
    return bm[0], engine._prep_rows(items, 32)[3][:bsz]


def counts(slots, gp: int, dev):
    """(B, Qmax) gram slots -> (B, gp) int32 multiplicities on ``dev``."""
    from ..search.candidates import query_counts

    return query_counts(torch.as_tensor(slots).to(dev), gp)
