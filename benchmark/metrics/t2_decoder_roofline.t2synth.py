"""The attention decode kernel (``csrc/attn_decode.cu``, traced as
``attn_decode_kernel``) against its roofline: the least time of the
traced calls' loops over the kernel's device time.

A call's least time is the larger of its operations (every kept frame's
step at its utterance's phonemes, ``counts.tacotron2.decoder_step_flops``)
over the bf16 peak and its bytes (the loop's weights once, each
utterance's memory read once, each frame written once) over the memory
rate.  The steps a row idles after its end are not counted."""

from benchmark.counts import tacotron2
from benchmark.counts.peaks import BF16_FLOPS, bound_s
from benchmark.readers import kernel_seconds

KERNELS = ("attn_decode_kernel",)


def read(run):
    t = kernel_seconds(run, KERNELS)
    if t is None:
        return None
    mc = run.config["model"]
    least = 0.0
    for call in run.traced["calls"]:
        flops = sum(f * tacotron2.decoder_step_flops(mc, L)
                    for L, f in call["utts"])
        least += bound_s(flops,
                         tacotron2.decoder_loop_bytes(mc, call["utts"], 2),
                         BF16_FLOPS)
    return 100.0 * least / t
