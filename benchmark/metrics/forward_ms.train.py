"""Device ms a step spends in the forward outside the scans: the span
``train.forward``"s self time (the batch"s assembly, encoder,
predictors, postnet, losses; a KD teacher"s forward and losses) in the
``train_step`` graph, per replay."""

from benchmark.spanread import span_ms


def read(run):
    return span_ms("train_step", ["train.forward"])
