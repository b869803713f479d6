"""Plain Parallel WaveGAN v1 generator (kan-bayashi's
``ParallelWaveGANGenerator``): mel + noise -> wav in fp32 PyTorch ops.

Conditioning: a context convolution, then per upsample scale a nearest
stretch and a (2s+1)-tap smoothing convolution.  Then the noise through a
1x1 convolution, ``layers`` residual blocks (dilated convolution plus the
conditioning's 1x1, gated tanh * sigmoid, residual and skip 1x1s), the
skips summed and scaled by sqrt(1 / layers), relu, 1x1, relu, 1x1.
Weights come as a state dict under the official module names.
"""

import math

import torch
import torch.nn.functional as F

from benchmark.reference.precision import exact_fp32


def dilations(vc):
    per_stack = vc["layers"] // vc["stacks"]
    return [2 ** (i % per_stack) for i in range(vc["layers"])]


def hop(vc):
    return int(math.prod(vc["upsample_scales"]))


def receptive_field(vc):
    """One-sided receptive field in samples: the conv stack plus the
    conditioning's context on the mel grid."""
    rf = sum((vc["kernel_size"] - 1) // 2 * d for d in dilations(vc))
    rf_mel = vc["aux_context_window"] + sum(vc["upsample_scales"])
    return rf + rf_mel * hop(vc)


def upsample(sd, vc, mel, pr):
    """(B, T, aux) -> (B, aux, T * hop)."""
    x = F.conv1d(pr.f32(mel).transpose(1, 2),
                 pr.f32(sd["upsample_net.conv_in.weight"]),
                 padding=vc["aux_context_window"])
    A = x.shape[1]
    for i, s in enumerate(vc["upsample_scales"]):
        taps = sd[f"upsample_net.upsample.up_layers.{2 * i + 1}.weight"]
        taps = pr.f32(taps.reshape(-1))
        x = x.repeat_interleave(s, dim=2)
        x = F.conv1d(x, taps.view(1, 1, -1).expand(A, 1, taps.numel()),
                     padding=(taps.numel() - 1) // 2, groups=A)
    return x


@torch.no_grad()
def generate(sd, vc, mel, noise, pr):
    """mel (B, T, aux), noise (B, T * hop) -> wav (B, T * hop), fp32."""
    with exact_fp32():
        aux = pr.f32(upsample(sd, vc, mel, pr))

        def conv(x, name, **kw):
            return F.conv1d(pr.f32(x), pr.f32(sd[name + ".weight"]),
                            sd.get(name + ".bias"), **kw)

        x = conv(noise[:, None, :], "first_conv")
        half = vc["gate_channels"] // 2
        skips = 0.0
        for i, d in enumerate(dilations(vc)):
            pre = f"conv_layers.{i}."
            h = conv(x, pre + "conv", dilation=d,
                     padding=(vc["kernel_size"] - 1) // 2 * d)
            h = h + conv(aux, pre + "conv1x1_aux")
            h = torch.tanh(h[:, :half]) * torch.sigmoid(h[:, half:])
            skips = skips + conv(h, pre + "conv1x1_skip")
            x = (conv(h, pre + "conv1x1_out") + x) * math.sqrt(0.5)
        x = torch.relu(skips * math.sqrt(1.0 / vc["layers"]))
        x = torch.relu(conv(x, "last_conv_layers.1"))
        return conv(x, "last_conv_layers.3")[:, 0]
