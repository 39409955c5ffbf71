"""latency_p95_ms: the 95th percentile (linear interpolation) of every
request's latency in the window, from the host arrays handed over to the
detections on the host."""

import numpy as np


def read(run):
    return float(np.percentile(np.asarray(run.window.latencies_ms(), dtype=np.float64), 95))
