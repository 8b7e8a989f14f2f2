"""95th percentile, in milliseconds, of the latency of every request that
completed inside the window, timed on the host from the start of its call
(host-to-device copy included) to its output being ready on the device."""

import numpy as np


def read(run):
    if not run.latencies_s:
        return None
    return float(np.percentile(np.asarray(run.latencies_s), 95)) * 1e3
