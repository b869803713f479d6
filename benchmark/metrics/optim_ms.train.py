"""Device ms a step spends in the update: the span ``train.optim`` (clip,
the optimizer, the BatchNorm write-back) of the ``train_step`` graph,
per replay."""

from benchmark.spanread import span_ms


def read(run):
    return span_ms("train_step", ["train.optim"])
