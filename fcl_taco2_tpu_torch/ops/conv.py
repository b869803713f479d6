"""1-D convolution, batch norm (eval and train) and layer norm (port of
``fcl_taco2_tpu/ops/conv.py``).

Public functions take channels-last ``(B, T, C)`` like the JAX package;
weights are in PyTorch's own layout (``nn.Conv1d``: ``(Cout, Cin, W)``).
"""

import torch
import torch.nn.functional as F


def conv1d(x, weight, bias=None):
    """Same-padded 1-D conv.  x: (B, T, Cin); weight: (Cout, Cin, W)."""
    pad = (weight.shape[-1] - 1) // 2
    out = F.conv1d(x.transpose(1, 2), weight, bias, padding=pad)
    return out.transpose(1, 2)


def batch_norm(x, weight, bias, running_mean, running_var, eps=1e-5):
    """Eval-mode BatchNorm over the channels of (B, T, C) with fp32
    statistics; the output keeps the input dtype
    (``fcl_taco2_tpu/ops/conv.py:85-88``)."""
    x32 = x.float()
    y = (x32 - running_mean.float()) * torch.rsqrt(running_var.float() + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def batch_norm_train(x, weight, bias, running_mean, running_var,
                     momentum=0.1, eps=1e-5, mask=None):
    """Train-mode BatchNorm over the positions of (B, T, C)
    (``fcl_taco2_tpu/ops/conv.py:47-88``): fp32 batch statistics, over the
    valid positions only when ``mask`` (B, T) is given; the output keeps
    the input dtype.  Returns ``(y, (new_mean, new_var))``: the running
    statistics updated by torch's rules (momentum 0.1, unbiased variance),
    returned as new state and never written into the caller's buffers."""
    x32 = x.float()
    if mask is None:
        n = x.shape[0] * x.shape[1]
        mean = x32.mean(dim=(0, 1))
        var = (x32 - mean).square().mean(dim=(0, 1))  # biased
        unbiased = var * (n / max(n - 1, 1))
    else:
        m = mask.float()[..., None]
        n = torch.clamp(m.sum(), min=1.0)
        mean = (x32 * m).sum(dim=(0, 1)) / n
        var = ((x32 - mean).square() * m).sum(dim=(0, 1)) / n
        unbiased = var * (n / torch.clamp(n - 1.0, min=1.0))
    y = (x32 - mean) * torch.rsqrt(var + eps)
    with torch.no_grad():
        new_mean = (1 - momentum) * running_mean + momentum * mean
        new_var = (1 - momentum) * running_var + momentum * unbiased
    return (y * weight.float() + bias.float()).to(x.dtype), (new_mean,
                                                            new_var)


def layer_norm(x, weight, bias, eps=1e-12):
    """LayerNorm over the last dim, fp32 statistics, output in the input
    dtype (espnet LayerNorm parity, ``ops/conv.py:91-101``)."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return y.to(x.dtype)
