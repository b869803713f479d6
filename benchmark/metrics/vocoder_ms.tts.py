"""Device ms a request spends in the vocoder: the span ``serve.vocoder``
(``TTSPipeline.synth_vocode``"s ``vocode`` call) of the ``tts_batch``
graph, per replay."""

from benchmark.spanread import span_ms


def read(run):
    return span_ms("tts_batch", ["serve.vocoder"])
