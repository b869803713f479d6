"""How much of the attention loop serves every row: 100 x the frames kept
over (the call's rows x the loop's steps), from the ``synthesize`` graph's
device counters ``ar.frames`` and ``ar.steps`` (``spans.count``) over the
process's untraced replays.  The loop runs to its call's longest row, so
the rest is steps of rows that have ended."""

from benchmark.spanread import graph_totals


def read(run):
    g = graph_totals("synthesize")
    counters = (g or {}).get("counters", {})
    steps, frames = counters.get("ar.steps"), counters.get("ar.frames")
    if not steps or frames is None:
        return None
    return 100.0 * frames / (int(run.mix["batch"]) * steps)
