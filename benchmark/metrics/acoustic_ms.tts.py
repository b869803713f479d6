"""Device ms a request spends in the acoustic model: the spans
``serve.frontend``, ``serve.decoder`` and ``serve.postnet`` of the
``tts_batch`` graph (self times), per replay."""

from benchmark.spanread import span_ms


def read(run):
    return span_ms("tts_batch",
                   ["serve.frontend", "serve.decoder", "serve.postnet"])
