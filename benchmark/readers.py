"""Arithmetic the metric readers share: the traced sub-window's device
time by kernel name, the utterances of a list of calls."""

# the port's hand-written kernels, by the names the profiler prints
CSRC_KERNELS = ("ar_decode_kernel", "pwg_stream_kernel")


def utterances(calls):
    """(phonemes, frames) of every utterance of ``calls``."""
    return [u for c in calls for u in c["utts"]]


def kernel_seconds(run, names):
    """Device seconds of the traced kernels whose names hold one of
    ``names``; None without a trace or without such a kernel."""
    if run.traced is None:
        return None
    s = sum(b - a for n, a, b in run.traced["dev"]
            if any(k in n for k in names)) / 1e9
    return s or None


def other_kernel_seconds(run):
    """Device seconds of the traced kernels that are not the port's own
    and not copies or fills."""
    if run.traced is None:
        return None
    return sum(b - a for n, a, b in run.traced["dev"]
               if not any(k in n for k in CSRC_KERNELS)
               and not n.startswith(("Memcpy", "Memset"))) / 1e9
