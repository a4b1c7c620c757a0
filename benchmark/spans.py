"""The program's own host spans in a traced window (``sslib.*``, opened by
``stringsearchlib_tpu_torch`` at each layer boundary and recorded by
torch.profiler on the clock of the card's events), as self time by name.

A span's self time is its duration less the union of the ``sslib.*`` spans
nested in it; torch ops inside a span count as the span's own time.  Spans
nest on the one host thread that makes the requests, so a span lies inside
its parent.  torch.profiler's event list drops a span that is the only
child of a span of the same name; the two self times sum the same either
way.  A program that opens no such span (one older than its spans) gives
None, and the metrics that read it are left out.
"""

from __future__ import annotations

PREFIX = "sslib."
ROOTS = ("sslib.search", "sslib.search_batch")


def _union(intervals: list) -> float:
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def tree(trace) -> list:
    """[(start, end, name, [child (start, end)])]: every ``sslib.*`` span of
    the trace's host events, with the spans directly nested in it."""
    spans = sorted((e for e in trace.host if e[2].startswith(PREFIX)),
                   key=lambda e: (e[0], -e[1]))
    out, stack = [], []
    for a, b, name in spans:
        while stack and not (stack[-1][0] <= a and b <= stack[-1][1]):
            stack.pop()
        node = (a, b, name, [])
        if stack:
            stack[-1][3].append((a, b))
        out.append(node)
        stack.append(node)
    return out


def self_us(trace) -> dict | None:
    """{span name: summed self time in microseconds}, or None when the trace
    holds no ``sslib.*`` span."""
    if trace is None:
        return None
    nodes = tree(trace)
    if not nodes:
        return None
    out: dict = {}
    for a, b, name, children in nodes:
        out[name] = out.get(name, 0.0) + (b - a) - _union(children)
    return out


def covered_share(trace) -> float | None:
    """The share of the root spans' time (one per public call) that the
    spans below them cover."""
    nodes = [n for n in tree(trace) if n[2] in ROOTS] if trace is not None else []
    whole = sum(b - a for a, b, _, _ in nodes)
    if whole <= 0:
        return None
    return sum(_union(children) for _, _, _, children in nodes) / whole


def per_query(run, names: tuple) -> float | None:
    """The self time of the spans ``names``, summed, in microseconds per
    query answered in the traced window."""
    selfs = self_us(run.trace)
    answered = run.window.attempted - run.window.failed
    if selfs is None or answered <= 0:
        return None
    return sum(selfs.get(n, 0.0) for n in names) / answered
