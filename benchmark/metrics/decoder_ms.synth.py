"""Device ms a call spends in the AR decoder: the span ``serve.decoder``
(``decode_segments``) of the ``synthesize`` graph, per replay."""

from benchmark.spanread import span_ms


def read(run):
    return span_ms("synthesize", ["serve.decoder"])
