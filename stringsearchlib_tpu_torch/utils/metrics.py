"""Observability: index stats, query latency counters, profiler hook.

PyTorch counterpart of ``stringsearchlib_tpu.utils.metrics``:

  * :func:`index_stats` - structured size counters for one index (keys,
    terms, grams, postings, bytes of its tensors on the device);
  * :class:`QueryMetrics` - a latency reservoir attached to a SearchEngine
    (enable with ``engine.metrics = QueryMetrics()``), giving count / qps /
    p50 / p99, and the sums of the engine's per-call counters (rows that
    went dense, rows retried, device chains dispatched and replayed);
  * :func:`span` - the engine's host spans (``sslib.<layer>``), recorded
    by ``torch.profiler`` when it is on, on the clock of the card's
    kernels and copies;
  * :func:`profile` - context manager around ``torch.profiler`` writing a
    trace directory (a Chrome/TensorBoard ``*.pt.trace.json``) with host
    spans and, on a card, its kernels.

Everything here is optional: with no profiler running a span costs about
half a microsecond, and the rest nothing when unused.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import threading
import time
from typing import Optional

import numpy as np
import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast

logger = logging.getLogger("stringsearchlib_tpu_torch")


def index_stats(host) -> dict:
    """Structured counters for one built index (JSON-serializable)."""
    d = host.device

    def _bytes(*tensors) -> int:
        return int(sum(t.numel() * t.element_size() for t in tensors))

    return {
        "keys": int(d.n_keys),
        "terms": int(host.n_terms),
        "terms_short_tier": int(d.n_short),
        "terms_long_tier": int(d.n_long),
        "grams": int(host.n_grams),
        "postings": int(d.gram_terms.shape[0]),
        "edges": int(d.edge_key.shape[0]),
        "max_term_len": int(host.max_term_len),
        "gram_size": host.config.gram_size,
        "wide": host.config.wide,
        "device": str(d.device),
        "device_bytes": _bytes(
            d.short_tokens, d.short_lengths, d.long_tokens, d.long_lengths,
            d.gram_ptr, d.gram_terms, d.edge_term, d.edge_key, d.edge_weight,
            d.term_edge_ptr, d.term_wmax, d.key_edge_ptr, d.key_edge_term,
            d.key_edge_weight, d.key_len,
        ),
    }


_OFF = contextlib.nullcontext()


def span(name: str):
    """A host span ``name`` around a block, recorded when torch.profiler is
    on (``profile`` below, or any ``torch.profiler.profile``) and a shared
    no-op otherwise.

    Recorded as a plain CPU op, not a user annotation: the profiler copies
    user annotations onto the card's timeline, where they would read as
    device activity."""
    if _autograd_profiler._is_profiler_enabled:
        return _RecordFunctionFast(name)
    return _OFF


class QueryMetrics:
    """Rolling query latency/throughput counters.

    A bounded reservoir of per-query wall latencies; percentile reads are
    O(window).  ``calls`` sums the engine's per-call counters
    (``SearchEngine.last_routing["call"]``).  Counter updates take a lock
    (the registry supports concurrent readers, and ``count += n`` is not
    atomic)."""

    def __init__(self, window: int = 4096):
        self._lock = threading.Lock()
        self._lat = collections.deque(maxlen=window)
        self.count = 0
        self.batched_queries = 0
        self.calls = collections.Counter()
        self._t_start = time.perf_counter()

    def record(self, seconds: float, queries: int = 1, call: Optional[dict] = None) -> None:
        with self._lock:
            self.count += queries
            if call:
                self.calls.update(call)
            if queries > 1:
                self.batched_queries += queries
                per = seconds / queries
                # cap reservoir writes per batch
                for _ in range(min(queries, 64)):
                    self._lat.append(per)
            else:
                self._lat.append(seconds)

    def snapshot(self) -> dict:
        with self._lock:
            lat = np.array(self._lat, dtype=np.float64)
            count = self.count
            calls = dict(self.calls)
        elapsed = max(time.perf_counter() - self._t_start, 1e-9)
        out = {
            "queries": count,
            "queries_per_sec": count / elapsed,
            "window": int(lat.size),
        }
        # rows answered by the dense path, and rows whose first candidate
        # pass failed its exactness guard: left out until a call counts
        # them (the sharded engines count neither)
        if "dense_rows" in calls:
            out["dense_rows"] = calls["dense_rows"]
        if "retry_fast" in calls:
            out["retried_rows"] = calls["retry_fast"]
        # device chains dispatched, and of them those replayed from a
        # captured graph
        if "chunks" in calls:
            out["chunks"] = calls["chunks"]
            out["graph_chunks"] = calls.get("graph_chunks", 0)
        if lat.size:
            out["p50_ms"] = float(np.percentile(lat, 50) * 1e3)
            out["p99_ms"] = float(np.percentile(lat, 99) * 1e3)
            out["mean_ms"] = float(lat.mean() * 1e3)
        return out

    def reset(self) -> None:
        with self._lock:
            self._lat.clear()
            self.count = 0
            self.batched_queries = 0
            self.calls.clear()
            self._t_start = time.perf_counter()


@contextlib.contextmanager
def profile(trace_dir: Optional[str] = None):
    """Capture a ``torch.profiler`` trace around a block into
    ``trace_dir`` (host activity, and the card's kernels where one is
    present).

    Usage::

        with metrics.profile("trace"):
            engine.search_batch(queries)
    """
    if trace_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=tensorboard_trace_handler(str(trace_dir)),
    ):
        yield
    logger.info("profiler trace written to %s", trace_dir)
