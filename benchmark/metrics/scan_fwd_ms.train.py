"""Device ms a step spends in the decoder scans" forward: the span
``scan.fwd`` (``ops/rnn_vjp.py``, both scans) of the ``train_step``
graph, per replay."""

from benchmark.spanread import span_ms


def read(run):
    return span_ms("train_step", ["scan.fwd"])
