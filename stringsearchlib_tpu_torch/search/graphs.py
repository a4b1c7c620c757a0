"""Captured device chains: one search chunk's launches replayed as a CUDA
graph.

Once its shapes are fixed, the device chain of a search chunk (a candidate
route's front end and finish, the dense path, the selection-only retry) is
the same few hundred launches every time.  ``ChainGraphs`` captures that
chain once per key (``chain_key``: the route, its inputs' shapes, the
resident tables it reads and every flag fixed at trace time) and replays it
for each later chunk of the key, so the host enqueues one graph where it
enqueued each kernel from Python.  The hand-written kernels (K1/K2, K5, K6,
the row gather) run inside the graph as they are.

What changes between calls of one shape - the chunk's query arrays, its
per-row limits and the threshold - is the graph's input: a replay fills the
graph's static input buffer from the host arrays through one pinned
staging buffer and one copy, so the key holds no such value and a
threshold is compared on the device as the eager chain compares it, in
float32.  Inputs already on the device (the retained hits of a selection
retry) are copied into static tensors of their own.

The first call of a key runs the chain eagerly on a side stream and
answers from that run (capture wants the lazy state of cuBLAS and of the
kernels set up on the capturing stream), then captures it there.  Every
graph draws its memory from one shared pool, and each replay's outputs
are copied out before the next replay, in stream order, so no later replay
can overwrite an answer still queued.  ``MAX_GRAPHS`` bounds the graphs
kept; the least recently used goes first.  The pool's memory is held for
the graphs' lifetime, beside the eager chains' cache: a capture that does
not fit the device, or that grows the pool past ``POOL_BUDGET``, drops
every graph and returns the pool, and its key runs eagerly from then on
(a chain that large is paced by the device, not by its enqueue).

The kernel wrappers count their launches in module counters
(``ops.kernels.count_launches``).  A capture launches nothing: while it
runs, this thread's counts go to the graph's tally, which every replay
adds to the counters.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import sys
import threading

import numpy as np
import torch

from ..ops import kernels

# byte alignment of each input in a graph's static input buffer
_ALIGN = 16
_DTYPES = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
}


# captures in progress (of any engine), and whether the collector was on
# before the first of them
_GC_LOCK = threading.Lock()
_gc_state = {"captures": 0, "was_on": False}


@contextlib.contextmanager
def _no_collection():
    """The garbage collector off while any thread captures: a collection
    that frees a graph in a dead reference cycle (another engine's) makes a
    call a capture forbids, and the capture fails."""
    with _GC_LOCK:
        if _gc_state["captures"] == 0:
            _gc_state["was_on"] = gc.isenabled()
            gc.disable()
        _gc_state["captures"] += 1
    try:
        yield
    finally:
        with _GC_LOCK:
            _gc_state["captures"] -= 1
            if _gc_state["captures"] == 0 and _gc_state["was_on"]:
                gc.enable()


def chain_key(route: str, inputs, tables=(), **flags) -> tuple:
    """The key of a chunk's chain: ``route``, each input's shape and dtype
    (host arrays or device tensors alike), the identity of the resident
    ``tables`` it reads (held by the graph, so an identity is never reused
    while its graph lives) and every flag fixed at trace time.  Pure
    Python: it reads no value of an input and touches no device."""
    return (
        route,
        tuple((tuple(a.shape), str(a.dtype)) for a in inputs),
        tuple(id(t) for t in tables),
        tuple(sorted(flags.items())),
    )


class _Graph:
    # the graph, its static input buffer and each host input's (offset,
    # bytes) there, its static device inputs, its outputs, its launches
    # ((module globals, counter, launches)), and the tables it reads (held,
    # so their identities in the key stay unique)
    __slots__ = ("graph", "dev", "layout", "dev_in", "outs", "launches",
                 "tables")


class ChainGraphs:
    """The captured chains of one engine on one CUDA device.  A graph's
    static buffers serve one chunk at a time: calls from several threads
    (the flat API's readers share an engine) take a lock from the fill to
    the copy-out, which orders them on the stream they share."""

    # graphs kept at once
    MAX_GRAPHS = 256
    # bytes the graphs' shared pool may hold: the candidate chunks' budget
    # (SearchEngine.BATCH_HBM_BUDGET) and a margin, so any chunk sized by
    # it is captured alone
    POOL_BUDGET = 8 << 30

    def __init__(self, device):
        self.device = torch.device(device)
        self._graphs: collections.OrderedDict = collections.OrderedDict()
        self._pool = None
        self._side = None
        self._lock = threading.Lock()
        # bytes the pool has grown by in captures since it was made
        self._pool_bytes = 0
        # graphs captured so far
        self.captures = 0

    def __len__(self) -> int:
        return len(self._graphs)

    def run(self, key, fn, arrays, threshold, dev_arrays=(), tables=()):
        """``fn(inputs, thr)`` -> a tuple of device tensors, ``inputs`` the
        device copies of the host ``arrays`` then of ``dev_arrays``, ``thr``
        the threshold as a 0-d float32 tensor.  Replayed from the graph of
        ``key`` where one was captured, else run eagerly, then captured.
        Returns (outputs, replayed); a replay's outputs are copies.  A key
        whose capture did not fit returns (None, False): the caller runs
        the chain eagerly."""
        with self._lock:
            if key not in self._graphs:
                return self._first(key, fn, arrays, threshold, dev_arrays,
                                   tables), False
            self._graphs.move_to_end(key)
            g = self._graphs[key]
            if g is None:
                return None, False
            self._fill(g, arrays, threshold, dev_arrays)
            g.graph.replay()
            for scope, name, n in g.launches:
                kernels.count_launches(scope, name, n)
            return tuple(o.clone() for o in g.outs), True

    def _fill(self, g: _Graph, arrays, threshold, dev_arrays) -> None:
        """The chunk's inputs into the graph's static buffers: one copy
        from a pinned staging buffer (the caching host allocator reuses it
        only once that copy has run), then the device inputs."""
        host = (*arrays, np.array([threshold], np.float32))
        stage = torch.empty(g.dev.shape[0], dtype=torch.uint8, pin_memory=True)
        buf = stage.numpy()
        for a, (off, n) in zip(host, g.layout):
            buf[off:off + n] = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
        g.dev.copy_(stage, non_blocking=True)
        for dst, src in zip(g.dev_in, dev_arrays):
            dst.copy_(src)

    def _first(self, key, fn, arrays, threshold, dev_arrays, tables):
        g = _Graph()
        host = (*arrays, np.array([threshold], np.float32))
        g.layout, off = [], 0
        for a in host:
            g.layout.append((off, a.nbytes))
            off += -(-a.nbytes // _ALIGN) * _ALIGN
        g.dev = torch.empty(max(off, _ALIGN), dtype=torch.uint8, device=self.device)
        g.dev_in = [torch.empty_like(t, memory_format=torch.contiguous_format)
                    for t in dev_arrays]
        g.tables = tuple(tables)
        self._fill(g, arrays, threshold, dev_arrays)
        views = [g.dev[o:o + n].view(_DTYPES[a.dtype]).view(a.shape)
                 for a, (o, n) in zip(host, g.layout)]
        inputs, thr = views[:-1] + g.dev_in, views[-1].view(())

        cur = torch.cuda.current_stream(self.device)
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        self._side.wait_stream(cur)
        with torch.cuda.stream(self._side):
            outs = fn(inputs, thr)
            g.graph = torch.cuda.CUDAGraph()
            reserved = torch.cuda.memory_reserved(self.device)
            fits = True
            try:
                with _no_collection(), kernels.capturing() as tally:
                    g.graph.capture_begin(pool=self._pool,
                                          capture_error_mode="thread_local")
                    try:
                        g.outs = fn(inputs, thr)
                    finally:
                        g.graph.capture_end()
            except torch.cuda.OutOfMemoryError:
                fits = False
            self._pool_bytes += torch.cuda.memory_reserved(self.device) - reserved
        cur.wait_stream(self._side)
        for o in outs:
            o.record_stream(cur)

        if not fits or self._pool_bytes > self.POOL_BUDGET:
            # every graph dropped and the pool returned to the device; the
            # key runs eagerly from now on
            del g
            self._graphs.clear()
            self._pool, self._pool_bytes = torch.cuda.graph_pool_handle(), 0
            torch.cuda.empty_cache()
            self._graphs[key] = None
        else:
            g.launches = tuple((vars(sys.modules[mod]), name, n)
                               for (mod, name), n in tally.items())
            self._graphs[key] = g
            self.captures += 1
        while len(self._graphs) > self.MAX_GRAPHS:
            self._graphs.popitem(last=False)
        return tuple(outs)
