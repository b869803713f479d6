"""The whole request's share of the card's dense bf16 peak (989 TFLOP/s,
H100 SXM at 700 W): the model's and the vocoder's operations for every
request the window completed (``counts/``, the utterances' own lengths)
over the window's seconds."""

from benchmark.counts import pwg, taco2
from benchmark.counts.peaks import BF16_FLOPS
from benchmark.readers import utterances


def read(run):
    if not run.calls or run.window_s <= 0:
        return None
    mc, vc = run.config["model"], run.config["vocoder"]
    flops = sum(taco2.synth_flops(mc, L, f) + pwg.vocode_flops(vc, f)
                for L, f in utterances(run.calls))
    return 100.0 * flops / run.window_s / BF16_FLOPS
