"""Parallel WaveGAN generator, mel -> waveform (port of
``fcl_taco2_tpu/vocoder/pwg.py``).

``ParallelWaveGAN`` holds the weights under the module names of the
official kan-bayashi ``ParallelWaveGANGenerator`` (``first_conv``,
``upsample_net.conv_in``, ``upsample_net.upsample.up_layers.{1,3,..}``,
``conv_layers.i.{conv,conv1x1_aux,conv1x1_out,conv1x1_skip}``,
``last_conv_layers.{1,3}``), so an official state dict loads with a key
check.  The functions keep the JAX package's names and arguments, the
module taking the place of the param pytree, and its channels-last
layouts: mel (B, T, aux), noise and wav (B, T * hop).

Architecture (v1): noise -> first 1x1 conv -> 30 residual blocks (dilated
conv, gated tanh/sigmoid, mel-conditioning 1x1, residual and skip 1x1s) ->
sum(skips) * sqrt(1/30) -> relu -> 1x1 -> relu -> 1x1.  The conditioning
is conv_in (context window, no bias) then per scale a nearest stretch and
a (2s+1)-tap smoothing conv (no bias), run as a depthwise conv.
"""

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from fcl_taco2_tpu_torch.ops.conv import conv1d
from fcl_taco2_tpu_torch.utils.device import resolve_device
from fcl_taco2_tpu_torch.utils.initializers import _torch_conv_


@dataclasses.dataclass(frozen=True)
class PWGConfig:
    layers: int = 30
    stacks: int = 3
    residual_channels: int = 64
    gate_channels: int = 128
    skip_channels: int = 64
    aux_channels: int = 80
    kernel_size: int = 3
    upsample_scales: Tuple[int, ...] = (4, 4, 4, 4)
    aux_context_window: int = 2

    @property
    def hop(self):
        return int(np.prod(self.upsample_scales))

    @property
    def dilations(self):
        per_stack = self.layers // self.stacks
        return [2 ** (i % per_stack) for i in range(self.layers)]


class _Stretch(nn.Module):
    """Placeholder of the official ``Stretch2d`` (no weights); keeps the
    smoothing convs at the odd ``up_layers`` indices."""

    def __init__(self, scale):
        super().__init__()
        self.scale = scale


class _Upsample(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        layers = []
        for s in cfg.upsample_scales:
            layers += [_Stretch(s),
                       nn.Conv2d(1, 1, (1, 2 * s + 1), bias=False,
                                 device=device)]
        self.up_layers = nn.ModuleList(layers)


class _ConvInUpsample(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        A = cfg.aux_channels
        self.conv_in = nn.Conv1d(A, A, 2 * cfg.aux_context_window + 1,
                                 bias=False, device=device)
        self.upsample = _Upsample(cfg, device)


class _ResidualBlock(nn.Module):
    def __init__(self, cfg, dilation, device):
        super().__init__()
        C, G, S = (cfg.residual_channels, cfg.gate_channels,
                   cfg.skip_channels)
        self.dilation = dilation
        self.conv = nn.Conv1d(C, G, cfg.kernel_size, dilation=dilation,
                              device=device)
        self.conv1x1_aux = nn.Conv1d(cfg.aux_channels, G, 1, bias=False,
                                     device=device)
        self.conv1x1_out = nn.Conv1d(G // 2, C, 1, device=device)
        self.conv1x1_skip = nn.Conv1d(G // 2, S, 1, device=device)


class ParallelWaveGAN(nn.Module):
    """The generator's weights in the official layout.

    ``device`` defaults to ``"cuda"`` and raises when no card is present;
    pass ``device="cpu"`` for the plain PyTorch path.  Weights are drawn
    from ``seed`` with the JAX package's init distributions (``pwg_init``);
    load trained or JAX weights with ``load_state_dict`` (see
    ``utils.params.pwg_params_from_jax`` and ``import_pwg_state_dict``).
    """

    def __init__(self, cfg: PWGConfig = PWGConfig(), device="cuda", seed=0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        C, S = cfg.residual_channels, cfg.skip_channels
        self.first_conv = nn.Conv1d(1, C, 1, device=dev)
        self.upsample_net = _ConvInUpsample(cfg, dev)
        self.conv_layers = nn.ModuleList(
            _ResidualBlock(cfg, d, dev) for d in cfg.dilations)
        self.last_conv_layers = nn.ModuleList([
            nn.ReLU(), nn.Conv1d(S, S, 1, device=dev),
            nn.ReLU(), nn.Conv1d(S, 1, 1, device=dev)])
        pwg_init_(self, torch.Generator().manual_seed(seed))
        self.eval()

    @property
    def device(self):
        return self.first_conv.weight.device

    def smoothing_taps(self):
        """The (2s+1,) smoothing taps of each upsample scale."""
        return [self.upsample_net.upsample.up_layers[2 * i + 1].weight[0, 0, 0]
                for i in range(len(self.cfg.upsample_scales))]


def pwg_init_(model, gen):
    """Seeded init with ``pwg_init``'s distributions: every conv torch's
    default U(+-1/sqrt(Cin * W)), the smoothing taps 1/(2s+1)."""
    _torch_conv_(model.first_conv, gen)
    _torch_conv_(model.upsample_net.conv_in, gen)
    for conv in model.upsample_net.upsample.up_layers[1::2]:
        with torch.no_grad():
            conv.weight.fill_(1.0 / conv.weight.shape[-1])
    for blk in model.conv_layers:
        for conv in (blk.conv, blk.conv1x1_aux, blk.conv1x1_out,
                     blk.conv1x1_skip):
            _torch_conv_(conv, gen)
    _torch_conv_(model.last_conv_layers[1], gen)
    _torch_conv_(model.last_conv_layers[3], gen)
    return model


def _smooth(x, taps):
    """Depthwise (2s+1)-tap conv of every channel of (B, W, A), 'same'
    zero padding."""
    A = x.shape[-1]
    w = taps.to(x.dtype).view(1, 1, -1).expand(A, 1, taps.shape[0])
    pad = (taps.shape[0] - 1) // 2
    return F.conv1d(x.transpose(1, 2), w, padding=pad,
                    groups=A).transpose(1, 2)


@torch.no_grad()
def upsample_mel(params, cfg: PWGConfig, mel):
    """(B, T, aux) -> (B, T*hop, aux): context conv + stretch/smooth chain
    (``pwg.py:103-123``), in ``mel``'s dtype."""
    x = conv1d(mel, params.upsample_net.conv_in.weight.to(mel.dtype))
    for scale, taps in zip(cfg.upsample_scales, params.smoothing_taps()):
        x = _smooth(x.repeat_interleave(scale, dim=1), taps)
    return x


@torch.no_grad()
def pwg_generate(params, cfg: PWGConfig, mel, noise):
    """mel (B, T, aux), noise (B, T*hop) -> wav (B, T*hop)
    (``pwg.py:126-150``)."""
    aux = upsample_mel(params, cfg, mel).transpose(1, 2)  # (B, A, N)
    x = F.conv1d(noise[:, None, :], params.first_conv.weight,
                 params.first_conv.bias)
    skips = 0.0
    half = cfg.gate_channels // 2
    for blk in params.conv_layers:
        residual = x
        h = F.conv1d(x, blk.conv.weight, blk.conv.bias,
                     padding=(cfg.kernel_size - 1) // 2 * blk.dilation,
                     dilation=blk.dilation)
        h = h + F.conv1d(aux, blk.conv1x1_aux.weight)
        h = torch.tanh(h[:, :half]) * torch.sigmoid(h[:, half:])
        s = F.conv1d(h, blk.conv1x1_skip.weight, blk.conv1x1_skip.bias)
        x = F.conv1d(h, blk.conv1x1_out.weight, blk.conv1x1_out.bias)
        x = (x + residual) * math.sqrt(0.5)
        skips = skips + s
    x = torch.relu(skips * math.sqrt(1.0 / cfg.layers))
    last1, last2 = params.last_conv_layers[1], params.last_conv_layers[3]
    x = torch.relu(F.conv1d(x, last1.weight, last1.bias))
    return F.conv1d(x, last2.weight, last2.bias)[:, 0]


@torch.no_grad()
def pwg_generate_chunked(params, cfg: PWGConfig, mel, noise,
                         chunk_frames=128, context_frames=40):
    """Memory-bounded vocoding (``pwg.py:153-192``): ``chunk_frames``-frame
    chunks with ``context_frames`` of context on each side, one after
    another, with the JAX package's static-pad convention at the
    utterance's edges.  mel (B, T, aux), noise (B, T*hop) -> (B, T*hop)."""
    B, T, _ = mel.shape
    hop = cfg.hop
    n_chunks = -(-T // chunk_frames)
    Tp = n_chunks * chunk_frames
    c = context_frames
    mel_p = F.pad(mel, (0, 0, c, Tp - T + c))
    noise_p = F.pad(noise, (c * hop, (Tp - T + c) * hop))
    width = chunk_frames + 2 * c
    chunks = []
    for k in range(n_chunks):
        s = k * chunk_frames
        w = pwg_generate(params, cfg, mel_p[:, s:s + width],
                         noise_p[:, s * hop:(s + width) * hop])
        chunks.append(w[:, c * hop:(c + chunk_frames) * hop])
    return torch.cat(chunks, dim=1)[:, :T * hop]


# ----------------------------------------------------------------------
# official checkpoint import
# ----------------------------------------------------------------------

def import_pwg_state_dict(sd, cfg: PWGConfig, device="cuda"):
    """A kan-bayashi ``ParallelWaveGANGenerator`` state dict (the 'model'
    -> 'generator' entry of their .pkl checkpoints) -> ``ParallelWaveGAN``
    (``pwg.py:199-237``).  The module names are the official ones, so this
    is a key check: a missing key raises, extra keys are ignored as the
    JAX importer ignores them."""
    model = ParallelWaveGAN(cfg, device=device)
    want = model.state_dict()
    missing = sorted(set(want) - set(sd))
    if missing:
        raise KeyError(f"PWG state dict lacks {missing[:4]}"
                       + (" ..." if len(missing) > 4 else ""))
    model.load_state_dict(
        {k: torch.as_tensor(np.asarray(
            sd[k].detach().cpu() if hasattr(sd[k], "detach") else sd[k]),
            dtype=torch.float32) for k in want})
    return model


def load_pwg_checkpoint(path, cfg: PWGConfig, device="cuda"):
    """Load an official .pkl checkpoint: {'model': {'generator': sd}}
    (``pwg.py:240-249``)."""
    payload = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(payload, dict) and "model" in payload:
        payload = payload["model"]
    if isinstance(payload, dict) and "generator" in payload:
        payload = payload["generator"]
    return import_pwg_state_dict(payload, cfg, device=device)
