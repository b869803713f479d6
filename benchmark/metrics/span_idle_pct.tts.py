"""The share of the untraced window in which the card ran no replay of
the ``tts_batch`` graphs: 100 x (1 - the device ns a replay's spans add up
to, every region of the graph, times the window's calls over the
window's seconds).  The profiler plays no part."""

from benchmark.spanread import idle_pct


def read(run):
    return idle_pct(run, "tts_batch")
