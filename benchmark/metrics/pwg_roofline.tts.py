"""Parallel WaveGAN's streaming kernel (``csrc/pwg_stream.cu``, traced as
``pwg_stream_kernel``) against its roofline: the least time of the traced
calls' vocoding, over the kernel's device time.

A call's least time is the larger of its operations over the 3xTF32 peak
(the configuration holds the vocoder to fp32 accuracy, which the tensor
cores give at three TF32 products each) and its bytes over the memory
rate; both count the utterance's own samples (frames x hop) only, so a
kernel that vocodes the unused end of the frame budget reads low."""

from benchmark.counts import pwg
from benchmark.counts.peaks import FP32_3XTF32_FLOPS, bound_s
from benchmark.readers import kernel_seconds

KERNELS = ("pwg_stream_kernel",)


def read(run):
    t = kernel_seconds(run, KERNELS)
    if t is None:
        return None
    vc = run.config["vocoder"]
    least = 0.0
    for call in run.traced["calls"]:
        samples = sum(f for _, f in call["utts"]) * pwg.hop(vc)
        least += bound_s(samples * pwg.stack_flops_per_sample(vc),
                         pwg.stack_bytes(vc, samples), FP32_3XTF32_FLOPS)
    return 100.0 * least / t
