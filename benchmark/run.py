"""Run one cell of the benchmark of ``stringsearchlib_tpu_torch`` on the card.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with a CUDA card (it exits 2,
printing no result, without one).  A run:

 1. makes its inputs from ``--seed``: the corpus of the cell's
    configuration and the mix's queries, through the generator the mix
    names (their seconds go on an earlier line, ``inputs_s``), and keeps
    them out of the collector's full passes (``gc.freeze``): they are the
    benchmark's, while the program's own objects, made after, are not;
 2. set-up (``setup_s``, from before the program is first imported to the
    first timed request): the import, ``build_index`` and the first request,
    which builds the resident tables the mix reads (``build_s``), then the
    rest of the warm-up requests;
 3. with ``--trace 0``, the window: requests until ``--seconds`` have
    passed; with ``--trace 1``, ``trace_requests`` requests under
    torch.profiler instead;
 4. reads the device's memory peak, frees the program's state, and
    compares a sample of the window's answers, drawn from the seed, with
    the plain reference (``reference/``) built from the same corpus;
    the line before the result carries what the window saw of the host
    (seconds in the collector, a fixed Python loop timed before and after,
    involuntary context switches) and the routes its requests took;
 5. prints the cell's metrics as one JSON line, last on stdout, with the
    numbers compared and their limits under ``checks``, last in that line
    and last on stderr.

It exits 3, printing no result, when ``jax``, ``jaxlib``, ``flax`` or the
JAX package is loaded once the window has closed.  On the card a plain
version of a kernel running in its place (any ``*_REF_CALLS`` counter of
the program moving) makes the run not correct.
"""

from __future__ import annotations

import os

# the program sets this on import when numpy is not yet loaded; the inputs
# load numpy first, so the benchmark sets it as the program would
os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")
os.environ["USE_FLAX"] = "0"

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import random  # noqa: E402
import resource  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
from collections import Counter  # noqa: E402

import torch  # noqa: E402
from torch.autograd.profiler import record_function  # noqa: E402

from . import check, corpus, loops, spec  # noqa: E402
from . import trace as tracelib  # noqa: E402
from .reference.index import ReferenceIndex  # noqa: E402

PROGRAM = "stringsearchlib_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "stringsearchlib_tpu")


@dataclasses.dataclass
class Run:
    """What a run measured, as the metric readers see it."""

    cell: spec.Cell
    setup_s: float
    build_s: float
    window: loops.Window
    trace: tracelib.Trace | None = None
    reference: ReferenceIndex | None = None


def forbidden_modules() -> list:
    """The loaded modules whose top-level name (before the first dot) is
    one of FORBIDDEN, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def plain_calls(since: dict | None = None) -> dict:
    """Every ``*_REF_CALLS`` counter of the program's modules that moved
    (from ``since``, or from 0): plain versions that ran in place of
    kernels."""
    since = since or {}
    out = {}
    for name, mod in list(sys.modules.items()):
        if mod is None or name.split(".")[0] != PROGRAM:
            continue
        for attr, v in vars(mod).items():
            key = f"{name}.{attr}"
            if attr.endswith("_REF_CALLS") and isinstance(v, int) and v != since.get(key, 0):
                out[key] = v - since.get(key, 0)
    return out


def _cache_dirs(root: str) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    program builds its own kernels under build/kernels there)."""
    base = os.path.join(root, "build", "bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _host_probe_ms() -> float:
    """Milliseconds of a fixed pure-Python loop, the least of three: how
    fast the host runs the program's Python at that moment."""
    best = float("inf")
    for _ in range(3):
        t = time.perf_counter()
        sum(i * i for i in range(200_000))
        best = min(best, time.perf_counter() - t)
    return best * 1e3


class _GcClock:
    """Seconds inside the garbage collector and its passes per generation,
    while registered in ``gc.callbacks``."""

    def __init__(self):
        self.seconds, self.passes, self._t = 0.0, [0, 0, 0], None

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.seconds += time.perf_counter() - self._t
            self.passes[info["generation"]] += 1


def _fail(msg: str, code: int) -> int:
    print(msg, file=sys.stderr, flush=True)
    return code


def main(argv=None, device=None, n_rows=None, root: str = spec.ROOT) -> int:
    """Run a cell; returns the exit code.  ``device`` and ``n_rows`` are
    the tests' hook: a CPU run at a tiny corpus (off the card, kernels run
    their plain versions, and no device number is measured)."""
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload, root)
    cfg, traffic = cell.config, cell.traffic
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            return _fail(f"{args.workload} needs {cell.chips} CUDA card(s); "
                         f"torch sees {torch.cuda.device_count()}", 2)
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    device = torch.device(device)
    if importlib.util.find_spec(PROGRAM) is None:
        return _fail(f"{PROGRAM} is not importable from {os.getcwd()}", 2)
    _cache_dirs(root)

    # 1. inputs, from the seed
    t = time.perf_counter()
    gen = cell.generator
    words, row_size, weights = corpus.make_corpus(cfg["corpus"], args.seed, n_rows, root)
    inputs = gen.make_inputs(cell, words, args.seed)
    gc.collect()
    gc.freeze()
    inputs_s = time.perf_counter() - t

    # 2. set-up
    t_setup = time.perf_counter()
    with record_function("bench.import"):
        prog = importlib.import_module(PROGRAM)
        buildmod = importlib.import_module(f"{PROGRAM}.index.build")
    plain_before = plain_calls()
    t = time.perf_counter()
    with record_function("bench.build_index"):
        host = prog.build_index(words, row_size, weights,
                                prog.IndexConfig(gram_size=int(cfg["gram_size"])),
                                device=device)
        _sync(device)
    breakdown = dict(getattr(buildmod, "LAST_BUILD_BREAKDOWN", {}))
    engine = prog.SearchEngine(host)
    call = gen.caller(cell, engine)
    with record_function("bench.first_request"):
        call(inputs.warmup[0])  # builds the resident tables this mix reads
        _sync(device)
    build_s = time.perf_counter() - t
    with record_function("bench.warmup"):
        for qs in inputs.warmup[1:]:
            call(qs)
        _sync(device)
    setup_s = time.perf_counter() - t_setup
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "inputs_s": inputs_s, "n_words": len(words),
                      "n_queries_drawn": len(inputs.pool), "build_s": build_s,
                      "build_breakdown": breakdown}, default=str), flush=True)

    # 3. the window
    sample = loops.Reservoir(int(traffic["check_queries"]),
                             random.Random(corpus.substream(args.seed, 3)))
    prof = None
    probe = [_host_probe_ms()]
    gc_clock = _GcClock()
    gc.callbacks.append(gc_clock)
    ru0, cpu0 = resource.getrusage(resource.RUSAGE_SELF), time.process_time()
    if args.trace:
        prof = tracelib.Profiler()
        with prof, record_function(tracelib.WINDOW_SPAN):
            win = gen.run_window(cell, call, engine, inputs.pool, sample,
                                 max_requests=int(traffic["trace_requests"]))
    else:
        win = gen.run_window(cell, call, engine, inputs.pool, sample, seconds=args.seconds)
    ru1, cpu1 = resource.getrusage(resource.RUSAGE_SELF), time.process_time()
    gc.callbacks.remove(gc_clock)
    probe.append(_host_probe_ms())
    host_seen = {"gc_s": gc_clock.seconds, "gc_passes": gc_clock.passes,
            "host_probe_ms": probe, "cpu_s": cpu1 - cpu0,
            "involuntary_switches": ru1.ru_nivcsw - ru0.ru_nivcsw,
            "routes": dict(Counter(str(r.get("variant")) for _, r in win.requests))}
    if win.wrapped:
        print("the window ran past the drawn queries and started over",
              file=sys.stderr, flush=True)

    # 4. after the window: memory, guards, then the reference
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda"
                   else device.type,
                   "count": cell.chips,
                   "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))
                   if device.type == "cuda" else 0}
    loaded = forbidden_modules()
    if loaded:
        return _fail(f"forbidden modules loaded: {loaded}", 3)
    plain = plain_calls(plain_before)
    if plain:
        print(f"plain versions ran: {plain}", file=sys.stderr, flush=True)
    run = Run(cell=cell, setup_s=setup_s, build_s=build_s, window=win)
    if prof is not None:
        run.trace = prof.result()
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
        del prof
    del engine, host, call, prog, buildmod
    gc.unfreeze()
    gc.collect()
    held = 0
    if device.type == "cuda":
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)

    t = time.perf_counter()
    ref = ReferenceIndex(words, row_size, weights, int(cfg["gram_size"]), device=device)
    want = ref.search_many([q for q, _ in win.sample], float(cfg["threshold"]),
                           int(cfg["limit"]))
    wrong = []
    for (q, got), w in zip(win.sample, want):
        why = check.answer_differs(got, w)
        if why is not None:
            wrong.append((q, why))
    ref_s = time.perf_counter() - t
    run.reference = ref
    chk = check.checks(len(wrong), win.failed, len(win.sample),
                       sum(plain.values()) if device.type == "cuda" else None)
    for q, why in wrong[:5]:
        print(f"wrong: {q!r}: {why}", file=sys.stderr)

    # 5. the line
    metrics = {}
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        kind = "metrics" if args.trace else "end_to_end"
        v = cell.reader(kind, m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    out = {"correct": check.passed(chk), "attempted": win.attempted,
           "failed": win.failed, "metrics": metrics, "device": device_info}
    if run.trace is not None:
        out["breakdown"] = {"device_ops": run.trace.device_ops(),
                            "idle_gaps": run.trace.idle_gaps()}
    out["checks"] = chk
    loaded = forbidden_modules()
    if loaded:
        return _fail(f"forbidden modules loaded: {loaded}", 3)
    print(json.dumps({**host_seen, "reference_s": ref_s, "held_after_free_bytes": held,
                      "reference_peak_bytes": int(torch.cuda.max_memory_allocated(device))
                      if device.type == "cuda" else 0,
                      "checked": len(win.sample),
                      "requests": len(win.latencies), "window_s": win.elapsed}),
          flush=True)
    for name, c in chk.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
