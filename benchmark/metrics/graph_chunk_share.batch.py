"""The share of the traced calls' chunk device chains that were replayed
from a captured CUDA graph: 100 x Σ``graph_chunks`` / Σ``chunks`` of the
program's per-call counters (``last_routing["call"]``, each summed over
every group, pass and tier of one call).  A program without them gives
None."""


def read(run):
    chunks = graphed = 0
    for _, routing in run.window.requests:
        call = routing.get("call")
        if call and "chunks" in call:
            chunks += int(call["chunks"])
            graphed += int(call.get("graph_chunks", 0))
    return 100.0 * graphed / chunks if chunks else None
