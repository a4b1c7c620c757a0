"""Queries answered in the window over the window's seconds (a batch counts
when its results are on the host)."""


def read(run):
    w = run.window
    return (w.attempted - w.failed) / w.elapsed if w.elapsed > 0 else None
