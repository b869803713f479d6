"""1-D convolution, batch norm (eval and train) and layer norm (port of
``fcl_taco2_tpu/ops/conv.py``).

Public functions take channels-last ``(B, T, C)`` like the JAX package;
weights are in PyTorch's own layout (``nn.Conv1d``: ``(Cout, Cin, W)``).

Inside ``synced_batch_norm(mesh)`` train-mode BatchNorm takes its
statistics over every rank of a data-parallel run (``_SyncedStats``), as
JAX's BatchNorm over a global batch does.
"""

import contextlib
import contextvars

import torch
import torch.nn.functional as F

# the mesh whose ranks share train-mode statistics, set in a scope
_SYNC = contextvars.ContextVar("synced_batch_norm", default=None)


@contextlib.contextmanager
def synced_batch_norm(mesh):
    """Within the block, train-mode ``batch_norm_train`` reduces its
    statistics over ``mesh``'s ranks; a mesh that is not ``distributed``
    (or None) changes nothing.  The train step enters it around its
    forward and backward (``train/step.py``)."""
    token = _SYNC.set(mesh if mesh is not None and mesh.distributed
                      else None)
    try:
        yield
    finally:
        _SYNC.reset(token)


class _SyncedStats(torch.autograd.Function):
    """Normalized activations with statistics over every rank: forward,
    one all-reduce of the per-channel sums and the count, then one of the
    centred sums of squares (the two passes of the single-process path);
    backward, one all-reduce of the per-channel sums of ``dy`` and
    ``dy * x_hat``.  ``m`` is the (B, T, 1) float mask or None.  Returns
    (x_hat, mean, biased var, n); only x_hat takes a gradient."""

    @staticmethod
    def forward(ctx, x32, m, mesh, eps):
        C = x32.shape[-1]
        if m is None:
            n_local = x32.new_full((1,), x32.shape[0] * x32.shape[1])
            s = x32.sum(dim=(0, 1))
        else:
            n_local = m.sum().reshape(1)
            s = (x32 * m).sum(dim=(0, 1))
        buf = mesh.all_reduce_(torch.cat([s, n_local]))
        n = torch.clamp(buf[C], min=1.0)
        mean = buf[:C] / n
        d = x32 - mean
        sq = d.square() if m is None else d.square() * m
        var = mesh.all_reduce_(sq.sum(dim=(0, 1))) / n
        r = torch.rsqrt(var + eps)
        x_hat = d * r
        ctx.mesh = mesh
        ctx.save_for_backward(x_hat, r, n, m if m is not None
                              else x32.new_ones(()))
        ctx.mark_non_differentiable(mean, var, n)
        return x_hat, mean, var, n

    @staticmethod
    def backward(ctx, g, *_):
        x_hat, r, n, m = ctx.saved_tensors
        C = g.shape[-1]
        buf = ctx.mesh.all_reduce_(torch.cat([g.sum(dim=(0, 1)),
                                              (g * x_hat).sum(dim=(0, 1))]))
        dx = r * (g - m / n * (buf[:C] + x_hat * buf[C:]))
        return dx, None, None, None


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
    returned as new state and never written into the caller's buffers.
    Inside ``synced_batch_norm`` the statistics are every rank's."""
    x32 = x.float()
    mesh = _SYNC.get()
    if mesh is not None:
        m = None if mask is None else mask.float()[..., None]
        y, mean, var, n = _SyncedStats.apply(x32, m, mesh, eps)
        unbiased = var * (n / torch.clamp(n - 1.0, min=1.0))
    elif mask is None:
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
    if mesh is None:
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
