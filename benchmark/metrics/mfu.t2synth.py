"""The whole call's share of the card's dense bf16 peak (989 TFLOP/s,
H100 SXM at 700 W): Tacotron2's operations for every utterance the window
completed (``counts/tacotron2.py``, the utterances' own lengths) over the
window's seconds."""

from benchmark.counts import tacotron2
from benchmark.counts.peaks import BF16_FLOPS
from benchmark.readers import utterances


def read(run):
    if not run.calls or run.window_s <= 0:
        return None
    mc = run.config["model"]
    flops = sum(tacotron2.synth_flops(mc, L, f)
                for L, f in utterances(run.calls))
    return 100.0 * flops / run.window_s / BF16_FLOPS
