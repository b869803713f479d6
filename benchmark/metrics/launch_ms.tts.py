"""Mean host ms inside ``graph.replay()`` of the ``tts_batch`` graphs
(``utils/graphs.py::Graphed``'s ``launch_ns``): the untraced replays, each
key's first left out."""

from benchmark.spanread import launch_ms


def read(run):
    return launch_ms("tts_batch")
