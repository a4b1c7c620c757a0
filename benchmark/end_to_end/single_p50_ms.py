"""The median over all single queries of the window, call to results on the
host, in milliseconds."""

import numpy as np


def read(run):
    lat = run.window.latencies
    return float(np.percentile(lat, 50) * 1e3) if lat else None
