"""The AR decoder kernel (``csrc/ar_decode.cu``, traced as
``ar_decode_kernel``) against its roofline: the least time of the traced
calls' decoder loops, over the kernel's device time.

A call's least time is the larger of its operations (every real frame's
step, ``counts.taco2.decoder_step_flops``) over the peak of the loop's
stated weight type (bf16: 989 TFLOP/s; fp32 held to fp32 accuracy: the
3xTF32 peak) and its bytes (the loop's weights once, each segment's
vectors read once, each frame written once) over the memory rate.
Padding segments and the steps past a segment's duration are not
counted."""

from benchmark.counts import taco2
from benchmark.counts.peaks import BF16_FLOPS, FP32_3XTF32_FLOPS, bound_s
from benchmark.readers import kernel_seconds

KERNELS = ("ar_decode_kernel",)


def read(run):
    t = kernel_seconds(run, KERNELS)
    if t is None:
        return None
    mc = run.config["model"]
    bf16 = run.config["precision"]["decoder_loop"] == "bfloat16"
    peak, wbytes = (BF16_FLOPS, 2) if bf16 else (FP32_3XTF32_FLOPS, 4)
    least = 0.0
    for call in run.traced["calls"]:
        segs = sum(L for L, _ in call["utts"])
        frames = sum(f for _, f in call["utts"])
        least += bound_s(frames * taco2.decoder_step_flops(mc),
                         taco2.decoder_loop_bytes(mc, segs, frames, wbytes),
                         peak)
    return 100.0 * least / t
