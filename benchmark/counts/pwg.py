"""Operations and bytes of the Parallel WaveGAN generator from its widths
and an utterance's own samples (frames x hop); the unvocoded tail of a
frame budget is not counted."""

import math


def hop(vc):
    return int(math.prod(vc["upsample_scales"]))


def stack_flops_per_sample(vc):
    """The noise's 1x1, every residual block (dilated convolution, the
    conditioning's 1x1, the skip and residual 1x1s), the two output 1x1s:
    the work of the generator's streaming kernel, per sample."""
    C, G, S, A = (vc["residual_channels"], vc["gate_channels"],
                  vc["skip_channels"], vc["aux_channels"])
    block = (2 * C * G * vc["kernel_size"] + 2 * A * G
             + 2 * (G // 2) * S + 2 * (G // 2) * C)
    return 2 * C + vc["layers"] * block + 2 * S * S + 2 * S


def upsample_flops(vc, frames):
    """The conditioning network: the context convolution on the mel grid,
    then each scale's smoothing taps on every upsampled channel."""
    A = vc["aux_channels"]
    f = frames * 2 * A * A * (2 * vc["aux_context_window"] + 1)
    n = frames
    for s in vc["upsample_scales"]:
        n *= s
        f += n * A * 2 * (2 * s + 1)
    return f


def weight_elements(vc):
    C, G, S, A = (vc["residual_channels"], vc["gate_channels"],
                  vc["skip_channels"], vc["aux_channels"])
    block = C * G * vc["kernel_size"] + G + A * G + (G // 2) * (S + C) \
        + S + C
    return 2 * C + vc["layers"] * block + S * S + S + S + 1


def stack_bytes(vc, samples):
    """Least bytes of the streaming kernel: fp32 weights once, each
    sample's conditioning vector and noise read once, its wav written
    once."""
    return 4 * weight_elements(vc) + samples * 4 * (vc["aux_channels"] + 2)


def vocode_flops(vc, frames):
    return upsample_flops(vc, frames) + frames * hop(vc) * \
        stack_flops_per_sample(vc)
