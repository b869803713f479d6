"""Shared network components (port of ``fcl_taco2_tpu/models/components.py``).

Parameters live in ``nn.Module``s in PyTorch's layouts; the ``*_apply``
functions keep the JAX names and take the module where JAX took a param
pytree.  At inference (``train=False``, the default) BatchNorm runs on its
running statistics and no dropout is drawn except the prenet's, which
stays on (reference ``decoder_sa.py:109-112``).  In train mode each
dropout draws from the step's ``torch.Generator`` and BatchNorm uses
batch statistics; a stack appends each BatchNorm's new running
statistics ``(mean, var)`` to the caller's ``bn_out`` list instead of
writing its buffers.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from fcl_taco2_tpu_torch.ops.conv import (batch_norm, batch_norm_train,
                                          conv1d, layer_norm)
from fcl_taco2_tpu_torch.ops.masking import masked_mean, weighted_masked_sum
from fcl_taco2_tpu_torch.ops.rnn import prenet_dropout


class BatchNorm(nn.Module):
    """BatchNorm parameters (``weight``/``bias``) and running statistics
    (``running_mean``/``running_var``); applied by ``ops.conv.batch_norm``."""

    def __init__(self, channels, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(channels, device=device))
        self.register_buffer("running_var",
                             torch.ones(channels, device=device))

    def forward(self, x):
        return batch_norm(x, self.weight, self.bias, self.running_mean,
                          self.running_var)


# --------------------------------------------------------------------------
# Prenet
# --------------------------------------------------------------------------

class Prenet(nn.Module):
    def __init__(self, idim, n_layers, n_units, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.Linear(idim if i == 0 else n_units, n_units, device=device)
            for i in range(n_layers))


def maybe_dropout(x, rate, generator, train):
    """Train-mode dropout (``components.py:32-40``); identity otherwise."""
    return prenet_dropout(x, rate, generator) if (train and rate > 0.0) \
        else x


def prenet_apply(prenet, x, generator, dropout_rate):
    """Prenet with ALWAYS-ON dropout (``components.py:67-74``)."""
    for layer in prenet.layers:
        x = prenet_dropout(F.relu(layer(x)), dropout_rate, generator)
    return x


# --------------------------------------------------------------------------
# Conv-BN stacks (encoder convs + postnet)
# --------------------------------------------------------------------------

class ConvBNStack(nn.Module):
    """n_layers of conv(width) -> [BN]; with ``last_is_out`` the last layer
    maps to ``out_ch`` (postnet shape)."""

    def __init__(self, n_layers, in_ch, hidden_ch, out_ch, width,
                 last_is_out=False, use_bn=True, device=None):
        super().__init__()
        chans = []
        for i in range(n_layers):
            ichans = in_ch if i == 0 else hidden_ch
            ochans = out_ch if (last_is_out and i == n_layers - 1) \
                else hidden_ch
            chans.append((ichans, ochans))
        self.convs = nn.ModuleList(
            nn.Conv1d(i, o, width, bias=False, device=device)
            for i, o in chans)
        self.bns = nn.ModuleList(
            BatchNorm(o, device=device) for _, o in chans) if use_bn \
            else nn.ModuleList()


def _bn(bn, x, train, mask, bn_out):
    if not train:
        return bn(x)
    y, new = batch_norm_train(x, bn.weight, bn.bias, bn.running_mean,
                              bn.running_var, mask=mask)
    bn_out.append(new)
    return y


def encoder_convs_apply(stack, x, use_residual=False, *, generator=None,
                        dropout_rate=0.0, train=False, seq_mask=None,
                        bn_out=None, capture=None):
    """conv -> BN -> ReLU -> dropout stack (``components.py:111-130``);
    in train mode ``seq_mask`` (B, T) keeps the BN statistics on valid
    positions.  ``capture`` (a list) receives each layer's output for
    KD."""
    for i, conv in enumerate(stack.convs):
        h = conv1d(x, conv.weight)
        if len(stack.bns):
            h = _bn(stack.bns[i], h, train, seq_mask, bn_out)
        h = F.relu(h)
        h = maybe_dropout(h, dropout_rate, generator, train)
        x = (x + h) if use_residual else h
        if capture is not None:
            capture.append(x)
    return x


def postnet_apply(stack, x, seq_mask=None, *, generator=None,
                  dropout_rate=0.0, train=False, bn_out=None, capture=None):
    """conv -> BN -> tanh -> dropout x(n-1), final conv -> BN -> dropout
    (``components.py:133-160``).  Returns the residual correction.
    ``seq_mask`` (B, T) zeroes activations past each utterance's length
    between layers (and, in train mode, keeps the BN statistics on valid
    positions).  ``capture`` (a list) receives each layer's output for
    KD."""
    n = len(stack.convs)
    for i, conv in enumerate(stack.convs):
        x = conv1d(x, conv.weight)
        if len(stack.bns):
            x = _bn(stack.bns[i], x, train, seq_mask, bn_out)
        if i < n - 1:
            x = torch.tanh(x)
        x = maybe_dropout(x, dropout_rate, generator, train)
        if seq_mask is not None:
            x = x * seq_mask[..., None].to(x.dtype)
        if capture is not None:
            capture.append(x)
    return x


# --------------------------------------------------------------------------
# Variance / duration predictors
# --------------------------------------------------------------------------

class VariancePredictor(nn.Module):
    def __init__(self, idim, n_layers, n_chans, kernel_size, output_dim=1,
                 device=None):
        super().__init__()
        self.convs = nn.ModuleList(
            nn.Conv1d(idim if i == 0 else n_chans, n_chans, kernel_size,
                      device=device)
            for i in range(n_layers))
        self.lns = nn.ModuleList(
            nn.LayerNorm(n_chans, eps=1e-12, device=device)
            for _ in range(n_layers))
        self.linear = nn.Linear(n_chans, output_dim, device=device)


def variance_predictor_apply(vp, x, pad_mask, generator=None,
                             dropout_rate=0.0, train=False):
    """(B, T, idim) -> (B, T, output_dim); padded positions zeroed
    (``components.py:186-198``)."""
    for conv, ln in zip(vp.convs, vp.lns):
        x = F.relu(conv1d(x, conv.weight, conv.bias))
        x = layer_norm(x, ln.weight, ln.bias)
        x = maybe_dropout(x, dropout_rate, generator, train)
    x = vp.linear(x)
    if pad_mask is not None:
        x = x.masked_fill(pad_mask[..., None], 0.0)
    return x


def duration_predictor_apply(vp, x, pad_mask, generator=None,
                             dropout_rate=0.0, train=False):
    """Log-domain durations (B, T), 0 at pads (``components.py:201-208``)."""
    out = variance_predictor_apply(vp, x, None, generator, dropout_rate,
                                   train)[..., 0]
    if pad_mask is not None:
        out = out.masked_fill(pad_mask, 0.0)
    return out


def duration_loss(logd_pred, targets_dur, mask, offset=1.0,
                  weighted_n_valid=None, count=None):
    """espnet DurationPredictorLoss: MSE in the log domain with offset,
    masked mean; ``weighted_n_valid`` switches to the use_weighted_masking
    reduction (``components.py:221-237``).  ``count``: the global batch's
    count of ``mask``'s True entries, for a rank's share of it."""
    target = torch.log(targets_dur.to(logd_pred.dtype) + offset)
    diff = (logd_pred - target) ** 2
    if weighted_n_valid is not None:
        return weighted_masked_sum(diff, mask, weighted_n_valid)
    return masked_mean(diff, mask, count)


def duration_predictor_inference(vp, x, pad_mask, offset=1.0):
    """espnet DurationPredictor.inference: round(exp(logd) - offset),
    clamp min 0, int (``components.py:211-218``)."""
    logd = variance_predictor_apply(vp, x, None)[..., 0]
    d = torch.clamp(torch.round(torch.exp(logd) - offset), min=0)
    d = d.to(torch.int32)
    if pad_mask is not None:
        d = d.masked_fill(pad_mask, 0)
    return d


def scalar_embed_apply(conv, x, generator=None, dropout_rate=0.0,
                       train=False):
    """(B, T, 1) scalar track -> (B, T, out_dim) (``components.py:252-255``;
    ``conv`` is an ``nn.Conv1d(1, out_dim, k)``)."""
    return maybe_dropout(conv1d(x, conv.weight, conv.bias), dropout_rate,
                         generator, train)
