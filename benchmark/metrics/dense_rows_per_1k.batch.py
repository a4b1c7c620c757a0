"""Query rows answered by the dense path per 1,000 queries of the traced
batches: the program's per-call counters (``last_routing["call"]``, each
summed over every group, pass and tier of one call), ``dense_rows`` over
``queries``.  A program without them gives None."""


def read(run):
    rows = queries = 0
    for _, routing in run.window.requests:
        call = routing.get("call")
        if call:
            rows += int(call["dense_rows"])
            queries += int(call["queries"])
    return 1000.0 * rows / queries if queries else None
