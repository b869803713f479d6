"""95th percentile of the latency of every request in the window, from
the call to the wav on the host (host clock)."""

import numpy as np


def read(run):
    if not run.latencies:
        return None
    return 1e3 * float(np.percentile(run.latencies, 95))
