"""Median latency of the window's requests, from the call to the wav on
the host (host clock): the serving entry's typical request, beside the
tail that ``tts_p95_ms`` holds."""

import numpy as np


def read(run):
    if not run.latencies:
        return None
    return 1e3 * float(np.median(run.latencies))
