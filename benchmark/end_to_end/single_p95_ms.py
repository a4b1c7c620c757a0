"""The 95th percentile over all single queries of the window, call to
results on the host, in milliseconds."""

import numpy as np


def read(run):
    lat = run.window.latencies
    return float(np.percentile(lat, 95) * 1e3) if lat else None
