"""Mel frames returned to the host in the window over the window's
seconds (host clock): every completed call's utterances' frames."""

from benchmark.readers import utterances


def read(run):
    if not run.calls or run.window_s <= 0:
        return None
    return sum(f for _, f in utterances(run.calls)) / run.window_s
