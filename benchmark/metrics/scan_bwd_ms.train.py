"""Device ms a step spends in the decoder scans" backward: the span
``scan.bwd`` (``ops/rnn_vjp.py``; with ``remat_decoder`` the recomputed
steps included) of the ``train_step`` graph, per replay."""

from benchmark.spanread import span_ms


def read(run):
    return span_ms("train_step", ["scan.bwd"])
