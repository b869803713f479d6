"""Device ms a step spends in the backward outside the scans and the
gathers: the span ``train.backward``"s self time in the ``train_step``
graph, per replay."""

from benchmark.spanread import span_ms


def read(run):
    return span_ms("train_step", ["train.backward"])
