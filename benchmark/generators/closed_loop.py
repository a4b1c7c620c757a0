"""A closed loop with one caller: it sends its next request when the last
one's results are on the host, so a slow system gets less load.

A mix that names this generator sets:

  ``queries``          the query model, ``benchmark/queries/<name>.py``;
  ``call``             "search_batch" (one request is ``batch`` queries) or
                       "search" (one request is one query);
  ``batch``            queries a request (1 for "search");
  ``batch_bucket``     ``search_batch``'s ``batch_bucket``;
  ``warmup_requests``  requests of set-up (their queries drawn apart);
  ``pool_queries``     queries drawn for the window (a window that runs
                       past them starts over, and the run says so);
  ``trace_requests``   requests in a traced run's window;
  ``check_queries``    answers of the window compared with the reference
                       (a uniform sample, drawn from the seed).
"""

import math
import random
import sys
import time
import traceback

from torch.autograd.profiler import record_function

from benchmark import corpus, loops, spec


def make_inputs(cell, words: list, seed: int) -> loops.Inputs:
    t = cell.traffic
    draw = spec.part(cell.root, "queries", t["queries"]).draw
    b = int(t["batch"])
    warm = draw(words, b * int(t["warmup_requests"]), random.Random(corpus.substream(seed, 2, 1)))
    return loops.Inputs(
        warmup=[warm[i: i + b] for i in range(0, len(warm), b)],
        pool=draw(words, int(t["pool_queries"]), random.Random(corpus.substream(seed, 2, 2))),
    )


def caller(cell, engine):
    """fn(queries) -> one (keys, scores) per query, through the mix's call."""
    thr, limit = float(cell.config["threshold"]), int(cell.config["limit"])
    if cell.traffic["call"] == "search_batch":
        bucket = int(cell.traffic["batch_bucket"])
        return lambda qs: engine.search_batch(qs, thr, limit, batch_bucket=bucket)
    if cell.traffic["call"] == "search":
        return lambda qs: [engine.search(q, thr, limit) for q in qs]
    raise ValueError(f"unknown call {cell.traffic['call']!r}")


def run_window(cell, call, engine, pool: list, sample: loops.Reservoir,
               seconds: float = math.inf, max_requests: int | None = None) -> loops.Window:
    """Requests of ``batch`` queries from ``pool``, one after another, until
    ``seconds`` have passed (the request in flight then completes) or
    ``max_requests`` were sent."""
    batch = int(cell.traffic["batch"])
    span = f"bench.{cell.traffic['call']}"
    lat, reqs = [], []
    attempted = failed = 0
    wrapped = False
    i = 0
    t_start = time.perf_counter()
    t_end = t_start
    while (max_requests is None or len(lat) < max_requests) and (
            time.perf_counter() - t_start < seconds):
        lo = (i * batch) % len(pool)
        qs = pool[lo: lo + batch]
        if len(qs) < batch:
            qs += pool[: batch - len(qs)]
        wrapped |= (i + 1) * batch > len(pool)
        i += 1
        t0 = time.perf_counter()
        try:
            with record_function(span):
                res = call(qs)
        except Exception:  # noqa: BLE001 - a failed request is counted, the loop goes on
            traceback.print_exc(file=sys.stderr)
            res = None
        t_end = time.perf_counter()
        lat.append(t_end - t0)
        attempted += len(qs)
        if res is None or len(res) != len(qs):
            failed += len(qs)
            continue
        answered = [(q, r) for q, r in zip(qs, res) if r is not None]
        failed += len(qs) - len(answered)
        sample.offer(answered)
        reqs.append((qs, dict(getattr(engine, "last_routing", {}) or {})))
    return loops.Window(lat, attempted, failed, t_end - t_start, sample.items, reqs, wrapped)
