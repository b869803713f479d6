"""The regroup gathers' backward on the card (``csrc/regroup.cu``), and the
autograd function that runs it.

``ops/regroup.py::_gather`` reads rows of ``x`` (the token grid, or the
concatenated class flats) at index plans that the host builds.  Its
gradient is the transpose: each position's gradient row added into the
row it was read from.  Autograd's indexing backward does that by sorting
the indices and letting one warp walk each run of equal ones, and every
plan aims all its padded positions at one sentinel row (``SENTINEL``), so
at batch 64 one warp walks ~29k rows a gather.  The kernel reads the
plan's inverse map instead: the valid positions' targets are one-to-one,
so each destination row is one source row or zero, written once, and the
padded positions' gradients are summed into the sentinel row by a
fixed-order parallel reduction (``csrc/regroup.cu`` has the design).

- ``RegroupGather``: ``x[indices]`` (the same op and numbers as plain
  indexing) whose backward is ``gather_backward``.
- ``gather_backward``: the kernel for CUDA tensors, bf16 or fp32 rows of
  whole 16-byte vectors (the widths in use: 80, 256, 512, 1024), and
  ``gather_backward_plain`` for CPU tensors.  There is no fallback: a
  CUDA tensor launches the kernel or raises, through
  ``utils/cuda_build.py``, which fills ``last_launch`` and counts its calls
  on the card (``gather_backward.launches``: inside a capture once a
  replay).
- ``gather_backward_plain``: autograd's own indexing backward,
  ``index_put_`` with accumulation into zeros.
"""

import ctypes
import math

import torch

from fcl_taco2_tpu_torch.utils.cuda_build import KIND, Entry, struct

SENTINEL = 0   # the row every padded position aims at (the plan builders')
STRIP = 128    # positions a block of the kernel's padding sum


class RegroupArgs(ctypes.Structure):
    """Mirror of ``struct RegroupArgs`` in csrc/regroup.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("g", "idx0", "idx1", "valid", "inv", "partial", "out")]
                + [("vstride", ctypes.c_longlong)]
                + [(n, ctypes.c_int) for n in ("stride0", "n", "rows", "cols",
                                               "sentinel", "strip")])


class RegroupLaunchInfo(ctypes.Structure):
    """Mirror of ``struct RegroupLaunchInfo`` in csrc/regroup.cu."""
    _fields_ = [(n, ctypes.c_int) for n in (
        "block_threads", "strips", "col_groups", "write_blocks",
        "sentinel_blocks")]


_GATHER_BWD = Entry.kernel("regroup", "regroup_gather_bwd_launch",
                           RegroupArgs, RegroupLaunchInfo, kind=True)
last_launch = _GATHER_BWD.last  # the newest launch's RegroupLaunchInfo


def gather_backward_plain(g, indices, valid, lead):
    """The gradient of ``x[indices]`` for ``x`` of shape ``(*lead, C)``,
    from its output's gradient ``g`` (``(*indices' shape, C)``): every
    position's row added into its target, valid or not (``valid`` is the
    kernel's shortcut, and changes nothing here)."""
    del valid
    out = g.new_zeros((*lead, g.shape[-1]))
    return out.index_put_(tuple(t.long() for t in indices), g,
                          accumulate=True)


def _check(g, indices, valid, lead):
    if g.dtype not in KIND:
        raise ValueError(f"the regroup kernel takes float32 or bfloat16 "
                         f"gradients, not {g.dtype}")
    C = g.shape[-1]
    if (C * g.element_size()) % 16:
        raise ValueError(f"the regroup kernel takes rows of whole 16-byte "
                         f"vectors; {C} {g.dtype} values are not")
    if len(indices) not in (1, 2) or len(lead) != len(indices):
        raise ValueError(f"the regroup kernel takes one or two index "
                         f"tensors into as many leading dims, not "
                         f"{len(indices)} into {tuple(lead)}")
    pos = g.shape[:-1]
    for t in (*indices, valid):
        if t.shape != pos or t.device != g.device:
            raise ValueError(f"indices and valid must have the positions' "
                             f"shape {tuple(pos)} on {g.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    if valid.dtype != torch.bool:
        raise ValueError(f"valid must be bool, not {valid.dtype}")
    if max(pos.numel(), math.prod(lead)) * C >= 2 ** 31:
        raise ValueError("the regroup kernel indexes with 32-bit offsets")


def gather_backward(g, indices, valid, lead):
    """``gather_backward_plain``'s gradient, by the kernel for CUDA
    tensors.  ``valid`` (bool, the positions' shape) marks the positions
    whose gradient is their own; the kernel relies on the plans'
    contract: the valid positions' targets are distinct, and every other
    position aims at row ``SENTINEL``."""
    if not g.is_cuda:
        return gather_backward_plain(g, indices, valid, lead)
    _check(g, indices, valid, lead)
    C, rows, n = g.shape[-1], math.prod(lead), g.shape[:-1].numel()
    g2 = g.reshape(n, C).contiguous()
    if g2.data_ptr() % 16:
        raise ValueError("the regroup kernel reads 16-byte aligned rows")
    out = torch.empty((rows, C), dtype=g.dtype, device=g.device)
    idx = [t.reshape(-1).to(torch.int32).contiguous() for t in indices]
    v = valid.reshape(-1)  # a view where it can be: the kernel takes a stride
    strips = -(-n // STRIP)
    inv = torch.empty(rows, dtype=torch.int32, device=g.device)
    partial = torch.empty((max(strips, 1), C), dtype=torch.float32,
                          device=g.device)
    two = len(idx) == 2
    args = struct(RegroupArgs, g=g2, idx0=idx[0], idx1=idx[1] if two else None,
                  valid=v, inv=inv, partial=partial, out=out,
                  vstride=v.stride(0), stride0=lead[1] if two else 1, n=n,
                  rows=rows, cols=C, sentinel=SENTINEL, strip=STRIP)
    _GATHER_BWD.launch(args, KIND[g.dtype], device=g.device,
                       count=gather_backward, context=f"{n} x {C} -> {rows}")
    return out.view(*lead, C)


gather_backward.launches = 0


class RegroupGather(torch.autograd.Function):
    """``x[indices]`` whose backward is ``gather_backward``; ``valid``
    (the positions' shape, bool) marks the positions that are not
    padding."""

    @staticmethod
    def forward(ctx, x, valid, *indices):
        ctx.save_for_backward(valid, *indices)
        ctx.lead = x.shape[:-1]
        return x[indices]

    @staticmethod
    def backward(ctx, g):
        valid, *indices = ctx.saved_tensors
        grad = gather_backward(g, tuple(indices), valid, ctx.lead)
        return (grad, None) + (None,) * len(indices)
