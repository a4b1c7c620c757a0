"""Device kernels launched per single query in the traced window, counted
from torch.profiler's device events (copies and sets left out)."""


def read(run):
    t, w = run.trace, run.window
    if t is None or not t.device or w.attempted <= 0:
        return None
    return len(t.kernels()) / w.attempted
