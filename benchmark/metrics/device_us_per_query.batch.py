"""Device busy microseconds (the union of kernels and copies in the traced
window, from torch.profiler) per query answered in it."""


def read(run):
    t, w = run.trace, run.window
    answered = w.attempted - w.failed
    if t is None or not t.device or answered <= 0:
        return None
    return t.busy_s * 1e6 / answered
