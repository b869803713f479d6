"""Arithmetic the span readers share: the program's own span totals
(``fcl_taco2_tpu_torch/utils/spans.py::totals``) for one graph name, per
replay.

A span's device time comes from marks captured inside the program's CUDA
graphs, summed over the process's untraced replays (set-up's calls and
the window; a replay under the profiler leaves the marks' slots and the
launch counter as they were), so a mean per replay is that mix's.  A
program without spans gives nothing to read (None), and so does a run
that captured no graph."""


def graph_totals(name):
    """``totals()[name]``, or None where the program has no spans or
    captured no graph of that name."""
    try:
        from fcl_taco2_tpu_torch.utils import spans
    except ImportError:
        return None
    totals = spans.totals()
    if totals is None:
        return None
    return totals.get(name)


def span_ms(graph, names):
    """Device ms a replay of ``graph`` spends in the spans ``names`` (self
    times, summed; each over the replays of the keys that hold it), or
    None where the graph holds none of them."""
    g = graph_totals(graph)
    if g is None:
        return None
    held = [g["spans"][n] for n in names if n in g["spans"]]
    if not held:
        return None
    return sum(s["ns"] / s["replays"] for s in held if s["replays"]) / 1e6


def launch_ms(graph):
    """Mean host ms inside ``graph.replay()`` of the untraced replays,
    each key's first replay (the graph's upload) left out."""
    g = graph_totals(graph)
    if g is None or not g["timed"]:
        return None
    return g["launch_ns"] / g["timed"] / 1e6


def idle_pct(run, graph):
    """100 x (1 - a replay's device time, every region of ``graph``,
    times the window's calls over the window's seconds): the share of the
    untraced window in which the card ran no replay of the graph."""
    g = graph_totals(graph)
    if g is None or not g["replays"] or not run.calls or run.window_s <= 0:
        return None
    busy_s = g["device_ns"] / g["replays"] / 1e9 * len(run.calls)
    return 100.0 * (1.0 - busy_s / run.window_s)
