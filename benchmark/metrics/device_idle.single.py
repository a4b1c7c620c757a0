"""1 - the union of device activity (kernels and copies) over the traced
window of single queries, from torch.profiler, in percent."""


def read(run):
    t = run.trace
    if t is None or not t.device or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
