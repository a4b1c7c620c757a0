"""Host microseconds per single query answered in the traced window,
enqueueing device work: the self time of the program's ``sslib.dispatch``
spans.

Inflated by the profiler: it adds host time to every torch op, and a single
query's dispatch is about 255 of them.  On an H100 80GB HBM3 at 700 W the
traced root span read 9.7-10.5 ms a query against an untraced p50 of 5.7 ms,
and the dispatch 8.4-9.2 ms of it, so this reads about twice the untraced
dispatch.  Compare it between traced runs only; size no untraced gain from
its microseconds."""

from benchmark import spans


def read(run):
    return spans.per_query(run, ("sslib.dispatch",))
