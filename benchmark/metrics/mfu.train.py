"""The whole step's share of the card's dense bf16 peak (989 TFLOP/s,
H100 SXM at 700 W): three times the trained model's forward operations
(forward, and a backward of twice the forward's) for every utterance of
every step the window completed, plus the frozen teacher's forward where
the configuration distils from one, over the window's seconds.  Counts
from ``counts/taco2.py`` at the utterances' own lengths."""

from benchmark.counts import taco2
from benchmark.counts.peaks import BF16_FLOPS
from benchmark.readers import utterances


def read(run):
    if not run.calls or run.window_s <= 0:
        return None
    mc = run.config["model"]
    teacher = run.config.get("teacher_model")
    flops = 0
    for L, f in utterances(run.calls):
        flops += 3 * taco2.synth_flops(mc, L, f, predict_durations=True)
        if teacher:
            flops += taco2.synth_flops(teacher, L, f, predict_durations=True)
    return 100.0 * flops / run.window_s / BF16_FLOPS
