"""Real (unpadded) target frames of every step the window completed, over
the window's seconds (host clock, the card synchronized at its end)."""

from benchmark.readers import utterances


def read(run):
    if not run.calls or run.window_s <= 0:
        return None
    return sum(f for _, f in utterances(run.calls)) / run.window_s
