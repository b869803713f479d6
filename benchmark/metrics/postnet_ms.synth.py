"""Device ms a call spends in the scatter and the postnet: the span
``serve.postnet`` of the ``synthesize`` graph, per replay."""

from benchmark.spanread import span_ms


def read(run):
    return span_ms("synthesize", ["serve.postnet"])
