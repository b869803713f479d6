"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
# fp32 products held to fp32 accuracy on the tensor cores take three TF32
# products each (3xTF32), so their peak is a third of TF32's
FP32_3XTF32_FLOPS = TF32_FLOPS / 3


def bound_s(flops, nbytes, peak_flops):
    """The least time of a piece of work: its operations over the peak of
    their precision or its bytes over the memory rate, the larger."""
    return max(flops / peak_flops, nbytes / HBM_BYTES_PER_S)
