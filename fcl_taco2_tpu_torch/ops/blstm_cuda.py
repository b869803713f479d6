"""The serving encoder's bidirectional LSTM as one CUDA kernel for Hopper
(``csrc/blstm.cu``).  It replaces no TPU kernel: the JAX package runs the
recurrence under ``jax.lax.scan`` (``fcl_taco2_tpu/ops/rnn.py:154``).  It
was added because the port ran it as a Python loop of small PyTorch
kernels a token and direction (``ops/rnn.py::lstm_scan``), whose gaps made
the serving frontend half of a batch-16 synthesis call.

``bilstm_infer`` is one layer of ``ops/rnn.py::bilstm`` without autograd,
for CUDA tensors: the input projections (one product a direction, as the
loop hoists them) and one kernel launch for the whole recurrence of both
directions, written straight into the (B, T, 2H) output.  There is no
fallback: it launches the kernel or raises (``models/encoder.py::
encoder_apply`` sends CPU tensors to the loop).  The kernel rounds where
the loop rounds (bf16 or fp32, the parameters' type) and differs from it
only in the recurrent product: the order of its sums and, for fp32
weights, 3xTF32 products (within ~1e-6).

The kernel reads each cell's ``weight_hh`` and ``bias_hh`` as they are
and puts its slice in fragment order while loading it, so a launch, eager
or replayed in a CUDA graph, runs the weights as they are then.
``bilstm_infer`` launches through ``utils/cuda_build.py``, which fills
``last_launch`` and counts the launches (``bilstm_infer.launches``: inside
a capture once a replay), and the device counter ``blstm.steps``
(``utils/spans.py::count``) adds each replay's loop steps, the batch's
longest row.
"""

import ctypes

import torch
import torch.nn.functional as F

from fcl_taco2_tpu_torch.utils import spans
from fcl_taco2_tpu_torch.utils.cuda_build import KIND, Entry, struct

MAX_UNITS = 256  # hidden units a direction: 8 blocks of 32


def geometry(H):
    """(UB, CS): hidden units a block and blocks a cluster for ``H`` units
    a direction.  16 units a block up to H = 128 (the student: 8 blocks),
    32 above (the teacher and Tacotron2 at H = 256: 8 blocks)."""
    if not 1 <= H <= MAX_UNITS:
        raise ValueError(f"the BiLSTM kernel takes 1..{MAX_UNITS} hidden "
                         f"units a direction, got {H}")
    ub = 16 if H <= 128 else 32
    return ub, -(-H // ub)


def check(params_fwd, params_bwd, xs, lengths):
    """Raise on what the kernel does not take; returns H."""
    if xs.dtype not in KIND:
        raise ValueError(f"the BiLSTM kernel takes float32 or bfloat16, not "
                         f"{xs.dtype}")
    if xs.dim() != 3 or xs.shape[0] < 1 or xs.shape[1] < 1:
        raise ValueError(f"xs must be (B, T, in) with B, T >= 1, got "
                         f"{tuple(xs.shape)}")
    if tuple(lengths.shape) != (xs.shape[0],) or lengths.is_floating_point():
        raise ValueError(f"lengths must be ({xs.shape[0]},) integers, got "
                         f"{tuple(lengths.shape)} {lengths.dtype}")
    H = params_fwd.weight_hh.shape[1]
    for p in (params_fwd, params_bwd):
        if p.weight_hh.dtype != xs.dtype or p.weight_ih.dtype != xs.dtype:
            raise ValueError(f"weights {p.weight_hh.dtype} and xs "
                             f"{xs.dtype} differ")
        if tuple(p.weight_hh.shape) != (4 * H, H) or \
                tuple(p.bias_hh.shape) != (4 * H,):
            raise ValueError(f"the cells' W_hh must both be (4H, H), got "
                             f"{tuple(params_fwd.weight_hh.shape)} and "
                             f"{tuple(params_bwd.weight_hh.shape)}")
    geometry(H)
    for name, t in (("lengths", lengths),
                    *((f"params_fwd.{n}", t)
                      for n, t in params_fwd.named_parameters()),
                    *((f"params_bwd.{n}", t)
                      for n, t in params_bwd.named_parameters())):
        if t.device != xs.device:
            raise ValueError(f"mixed devices: {name} is on {t.device}, xs "
                             f"on {xs.device}")
    if not xs.is_cuda:
        raise ValueError("the BiLSTM kernel runs on the card; CPU tensors "
                         "take ops/rnn.py::bilstm")
    return H


class BlstmArgs(ctypes.Structure):
    """Mirror of ``struct BlstmArgs`` in csrc/blstm.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("xf", "xb", "wf", "wb", "bf", "bb", "lens", "out",
                  "steps")]
                + [(n, ctypes.c_int) for n in ("B", "T", "H", "UB", "CS")])


class BlstmLaunchInfo(ctypes.Structure):
    """Mirror of ``struct BlstmLaunchInfo`` in csrc/blstm.cu."""
    _fields_ = [(n, ctypes.c_int) for n in ("grid", "cluster",
                                            "units_per_block",
                                            "block_threads", "smem_bytes")]


_BLSTM = Entry.kernel("blstm", "blstm_launch", BlstmArgs, BlstmLaunchInfo,
                      kind=True)
last_launch = _BLSTM.last  # the newest launch's BlstmLaunchInfo


def bilstm_infer(params_fwd, params_bwd, xs, lengths):
    """``ops/rnn.py::bilstm`` of (B, T, in) CUDA ``xs`` with ``lengths``
    (B,) by the kernel.  Returns (B, T, 2H) in ``xs``' dtype."""
    H = check(params_fwd, params_bwd, xs, lengths)
    ub, cs = geometry(H)
    B, T, _ = xs.shape
    xf = F.linear(xs, params_fwd.weight_ih, params_fwd.bias_ih).contiguous()
    xb = F.linear(xs, params_bwd.weight_ih, params_bwd.bias_ih).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty(B, T, 2 * H, dtype=xs.dtype, device=xs.device)
    steps = torch.empty(1, dtype=torch.int32, device=xs.device)
    wf, wb, bf, bb = (t.detach().contiguous() for t in (
        params_fwd.weight_hh, params_bwd.weight_hh, params_fwd.bias_hh,
        params_bwd.bias_hh))
    args = struct(BlstmArgs, xf=xf, xb=xb, wf=wf, wb=wb, bf=bf, bb=bb,
                  lens=lens, out=out, steps=steps, B=B, T=T, H=H, UB=ub,
                  CS=cs)
    _BLSTM.launch(args, KIND[xs.dtype], device=xs.device, count=bilstm_infer,
                  context=f"B={B}, T={T}, H={H}")
    spans.count("blstm.steps", steps)
    return out


bilstm_infer.launches = 0
