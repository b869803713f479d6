"""Device ms a step spends in the regroup gathers' backward: the span
``regroup.bwd`` (``ops/regroup.py::_gather``) of the ``train_step``
graph, per replay."""

from benchmark.spanread import span_ms


def read(run):
    return span_ms("train_step", ["regroup.bwd"])
