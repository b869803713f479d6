"""Device ms a call spends in the frontend: the span ``serve.frontend``
(encoder, predictors, the segment plan, the token gather) of the
``synthesize`` graph, per replay."""

from benchmark.spanread import span_ms


def read(run):
    return span_ms("synthesize", ["serve.frontend"])
