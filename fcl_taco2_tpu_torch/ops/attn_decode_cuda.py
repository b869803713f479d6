"""Tacotron2's attention decoder loop as one CUDA kernel for Hopper
(``csrc/attn_decode.cu``).  It replaces no TPU kernel: the JAX package has
no attention decoder.  It was added for the Tacotron2 baseline
(``models/tacotron2.py``), whose AR loop runs the whole utterance.

``attn_decode`` launches the kernel once a call for CUDA tensors: every
step's attention, prenet, both ZoneOut LSTM cells, ``feat_out`` and
``prob_out``, with bf16 weights, fp32 sums, fp32 ``h`` and ``c`` and an
fp32 softmax, the loop running until the call's last row has ended.  For
CPU tensors it runs ``attn_decode_plain``, the same arithmetic in PyTorch
ops; there is no fallback, a CUDA tensor launches the kernel or raises.
The weights are packed once (``pack_attn_weights``, ``pack_b``'s fragment
order and ``gate_order``'s slices of ``ops/decoder_cuda.py``).

Per step ``t`` of row ``b`` (``lp``: an operand rounded to the loop's
weight type)::

    q     = lp(h0) @ W_dec                             h0 of step t-1
    loc_j = sum_k lp(w_cum)_{j+k-P} M_k                the folded filter
    e_j   = g . tanh(pe_j + q + loc_j) + b_g           j < ilen
    alpha = softmax(2 e);  att_c = sum_j alpha_j enc_j
    w_cum = alpha (t = 0), w_cum + alpha (t > 0)
    p     = drop(relu(lp(drop(relu(lp(prev) @ W1 + b1))) @ W2 + b2))
    h0, c0 = zoneout(LSTM0(lp([att_c, p]), lp(h0)))
    h1, c1 = zoneout(LSTM1(lp(h0), lp(h1)))
    [out_t, stop_t] = lp([h1, att_c]) @ [W_feat; w_prob] (+ b_prob)

A row ends after ``t + 1`` frames where ``t + 1 >= hi`` or ``t + 1 >= lo``
and ``stop_t >= thr_logit`` (``length_bounds``: espnet's min and max
length ratios, or one pinned length for both).  Frames, stop logits and
weights of a row past its end are zero.  The prenet dropout stays on and
is keyed on (seed, row = the utterance's index in the call, step, layer,
unit), the Philox4x32-10 of ``csrc/mma_common.cuh``; ``prenet_keep`` is
the same keying in integer tensor arithmetic, so the plain version and
the kernel draw the same masks.  ``seed`` is an int32 tensor of one
element read on the device, so a CUDA graph replays a fresh seed.

The launch goes through ``utils/cuda_build.py``, which fills
``last_launch`` and counts the launches (``attn_decode.launches``).
"""

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from fcl_taco2_tpu_torch.ops.decoder_cuda import gate_order, pack_b
from fcl_taco2_tpu_torch.utils.cuda_build import (Entry, r16, seed_tensor,
                                                  seed_value, struct)

SENT = 0x7FFFFFFF  # a row's length before it is decided
UB = 8             # hidden units a block owns (csrc/attn_decode.cu)
MAX_ROWS = 256     # rows a call (one thread a row in the stop decisions)
MAX_POS = 256      # encoder positions (one fp32 of shared memory each)

# ---------------------------------------------------------------------------
# the prenet dropout's keying
# ---------------------------------------------------------------------------

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_K1 = 0x5BD1E995
_MASK = 0xFFFFFFFF


def _philox_first_word(seed, c0, c1, c2):
    """Philox4x32-10's first output word for key (seed, 0x5BD1E995) and
    counter (c0, c1, c2, 0), int64 tensors of 32-bit values."""
    x0, x1, x2 = torch.broadcast_tensors(c0, c1, c2)
    x3 = torch.zeros_like(x0)
    k0, k1 = int(seed) & _MASK, _K1
    for _ in range(10):
        p0, p1 = x0 * _M0, x2 * _M1  # < 2**64: wraps, low 64 bits kept
        x0, x1, x2, x3 = (((p1 >> 32) & _MASK) ^ x1 ^ k0, p1 & _MASK,
                          ((p0 >> 32) & _MASK) ^ x3 ^ k1, p0 & _MASK)
        k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
    return x0


def prenet_keep(seed, rate, rows, step, layer, units):
    """(rows, units) bool: the prenet units kept at ``step`` and ``layer``
    for the call's rows 0..rows-1, as the kernel draws them."""
    r = torch.arange(rows, dtype=torch.int64)[:, None]
    u = (layer * units + torch.arange(units, dtype=torch.int64))[None, :]
    bits = _philox_first_word(seed, r, torch.tensor(step), u)
    return bits < int((1.0 - float(rate)) * 4294967296.0)


# ---------------------------------------------------------------------------
# weights, lengths and the plain version
# ---------------------------------------------------------------------------

def location_filter(att, dtype):
    """The location convolution and its projection (``models/attention.py::
    AttLoc``'s ``loc_conv`` and ``mlp_att``, two linear maps in a row) as
    one filter: (taps, att_dim) fp32 holding ``dtype``-rounded values,
    ``M[k] = sum_c conv[c, k] W_att[:, c]`` taken in float64."""
    conv = att.loc_conv.weight[:, 0, :].double()       # (chans, taps)
    m = conv.t() @ att.mlp_att.weight.double().t()      # (taps, att_dim)
    return m.to(dtype).float()


def initial_weights(ilens, T):
    """The first step's ``w_cum``: 1 / ilen over each row's positions
    (B, T) fp32 (espnet's ``att_prev`` at the first step)."""
    valid = torch.arange(T, device=ilens.device)[None, :] < ilens[:, None]
    return valid.float() / ilens.clamp(min=1)[:, None].float()


def decoder_weights(decoder):
    """The loop's weights of a ``models/tacotron2.py::T2Decoder`` (views,
    PyTorch layouts)."""
    att, pre = decoder.att, decoder.prenet.layers
    l0, l1 = decoder.lstm
    return {
        "att": att, "w_dec": att.mlp_dec.weight, "g": att.gvec.weight[0],
        "b_g": att.gvec.bias, "w1": pre[0].weight, "b1": pre[0].bias,
        "w2": pre[1].weight, "b2": pre[1].bias,
        "wx0": l0.weight_ih, "wh0": l0.weight_hh,
        "bx0": l0.bias_ih, "bh0": l0.bias_hh,
        "wx1": l1.weight_ih, "wh1": l1.weight_hh,
        "bx1": l1.bias_ih, "bh1": l1.bias_hh,
        "w_feat": decoder.feat_out.weight, "w_prob": decoder.prob_out.weight,
        "b_prob": decoder.prob_out.bias,
    }


def length_bounds(ilens, budget, lengths=None, minlenratio=0.0,
                  maxlenratio=10.0):
    """(lo, hi) int32 (B,): a row may end once it has ``lo`` frames and
    ends at ``hi`` (at most ``budget``): espnet's ``int(ilen *
    minlenratio)`` and ``int(ilen * maxlenratio)``, or ``lengths`` for
    both.  Device ops only, so a CUDA graph captures them."""
    if lengths is not None:
        n = lengths.to(torch.int64).clamp(0, budget)
        return n.to(torch.int32), n.to(torch.int32)
    il = ilens.to(torch.float64)
    lo = torch.floor(il * float(minlenratio)).to(torch.int64)
    hi = torch.floor(il * float(maxlenratio)).to(torch.int64)
    return (lo.clamp(0, budget).to(torch.int32),
            hi.clamp(0, budget).to(torch.int32))


def _zoneout_cell(gates, h, c, zoneout):
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    keep = 1.0 - zoneout
    return zoneout * h + keep * h_new, zoneout * c + keep * c_new


def attn_decode_plain(w, enc, pe, ilens, lo, hi, seed, *, budget,
                      zoneout=0.1, dropout=0.5, thr_logit=0.0,
                      weights_dtype=torch.bfloat16):
    """The loop in PyTorch ops, on ``enc``'s device: ``attn_decode``'s
    path for CPU tensors, and on the card the kernel's reference
    (``chip_smoke.py``'s ``[attn_decode]``).  ``w``: ``decoder_weights``;
    enc (B, T, E) in the compute dtype and pe (B, T, A) fp32 from the
    frontend; ``seed`` an int or a one-element tensor (read on the host).
    Returns dict(out (B, budget, odim), stop (B, budget), att (B, budget,
    T), olens (B,) int32, steps (1,) int32)."""
    B, T, E = enc.shape
    dev = enc.device
    seed = seed_value(seed)

    def lp(x):
        return x.to(weights_dtype).float()

    H, O = w["wh0"].shape[1], w["w_feat"].shape[0]
    U = w["w1"].shape[0]
    M = location_filter(w["att"], weights_dtype)           # (taps, A)
    pad = (M.shape[0] - 1) // 2
    w_dec = lp(w["w_dec"]).t()
    g, b_g = w["g"].float(), w["b_g"].float()
    w1, w2 = lp(w["w1"]).t(), lp(w["w2"]).t()
    b1, b2 = w["b1"].float(), w["b2"].float()
    wx0, wh0 = lp(w["wx0"]).t(), lp(w["wh0"]).t()
    wx1, wh1 = lp(w["wx1"]).t(), lp(w["wh1"]).t()
    bias0 = w["bx0"].float() + w["bh0"].float()
    bias1 = w["bx1"].float() + w["bh1"].float()
    w_z = lp(torch.cat([w["w_feat"], w["w_prob"]])).t()      # (H+E, O+1)
    b_prob = w["b_prob"].float()
    enc, pe = enc.float(), pe.float()
    ilens = ilens.to(torch.int64)
    valid = torch.arange(T, device=dev)[None, :] < ilens[:, None]
    w_cum = initial_weights(ilens, T)
    h0 = c0 = h1 = c1 = torch.zeros(B, H, device=dev)
    prev = torch.zeros(B, O, device=dev)
    out = torch.zeros(B, budget, O, device=dev)
    stop = torch.zeros(B, budget, device=dev)
    att = torch.zeros(B, budget, T, device=dev)
    lens = torch.where(hi.to(torch.int64) <= 0, 0, SENT)
    lo, hi = lo.to(torch.int64), hi.to(torch.int64)
    scale = 1.0 / (1.0 - dropout) if dropout > 0 else 1.0

    def drop(x, step, layer):
        if dropout <= 0:
            return x
        keep = prenet_keep(seed, dropout, B, step, layer, U).to(dev)
        return torch.where(keep, x * scale, torch.zeros_like(x))

    t = 0
    while t < budget:
        live = lens > t
        if not bool(live.any()):
            break
        q = lp(h0) @ w_dec
        loc = F.conv1d(lp(w_cum)[:, None, :], M.t()[:, None, :],
                       padding=pad).transpose(1, 2)
        e = torch.tanh(pe + q[:, None, :] + loc) @ g + b_g
        alpha = torch.softmax(2.0 * e.masked_fill(~valid, float("-inf")),
                              dim=1)
        alpha = torch.where(valid, alpha, 0.0)
        att_c = (alpha[:, :, None] * enc).sum(dim=1)
        w_cum = alpha if t == 0 else w_cum + alpha
        p = drop(torch.relu(lp(prev) @ w1 + b1), t, 0)
        p = drop(torch.relu(lp(p) @ w2 + b2), t, 1)
        h0n, c0 = _zoneout_cell(lp(torch.cat([att_c, p], dim=1)) @ wx0
                                + lp(h0) @ wh0 + bias0, h0, c0, zoneout)
        h0 = h0n
        h1, c1 = _zoneout_cell(lp(h0) @ wx1 + lp(h1) @ wh1 + bias1, h1, c1,
                               zoneout)
        z = lp(torch.cat([h1, att_c], dim=1)) @ w_z
        prev, s = z[:, :O], z[:, O] + b_prob
        keep = live[:, None].float()
        out[:, t] = prev * keep
        stop[:, t] = s * live.float()
        att[:, t] = alpha * keep
        ends = live & ((t + 1 >= hi) | ((t + 1 >= lo) & (s >= thr_logit)))
        lens = torch.where(ends, t + 1, lens)
        t += 1
    olens = torch.where(lens == SENT, 0, lens)
    return {"out": out, "stop": stop, "att": att,
            "olens": olens.to(torch.int32),
            "steps": torch.tensor([t], dtype=torch.int32, device=dev)}


# ---------------------------------------------------------------------------
# the kernel's operands
# ---------------------------------------------------------------------------

def _rows(m, at, total):
    """(total, N): ``m``'s rows at ``at`` offsets (a list of (row, src
    slice)), zeros elsewhere."""
    out = m.new_zeros(total, m.shape[1])
    for dst, (a, b) in at:
        out[dst:dst + b - a] = m[a:b]
    return out


class PackedAttn(NamedTuple):
    """The loop's weights as ``csrc/attn_decode.cu`` takes them, made once
    by ``pack_attn_weights``: matrices bf16 in ``pack_b``'s fragment order
    (K padded to 16), the gate matrices' columns in ``gate_order`` for
    ``UB`` units a block, vectors fp32."""
    H: int
    E: int
    A: int
    U: int
    O: int
    taps: int
    w_dec: torch.Tensor   # (Hp x Ap)
    m_loc: torch.Tensor   # (taps x Ap)
    g: torch.Tensor       # (A,)
    b_g: torch.Tensor     # (1,)
    w1: torch.Tensor      # (Op x Up)
    b1: torch.Tensor
    w2: torch.Tensor      # (Up x Up)
    b2: torch.Tensor
    wx0: torch.Tensor     # ((Ep + Up) x 4H): [att_c | p] rows
    wh0: torch.Tensor     # (H x 4H)
    wx1: torch.Tensor
    wh1: torch.Tensor
    bias0: torch.Tensor   # (4H,) bias_ih + bias_hh
    bias1: torch.Tensor
    w_z: torch.Tensor     # ((Hp + Ep) x (O + 1)): [h1 | att_c] rows
    b_prob: torch.Tensor  # (1,)


def pack_attn_weights(w):
    """Pack ``decoder_weights(...)`` once for the kernel (bf16)."""
    bf, f32 = torch.bfloat16, torch.float32
    H, O = w["wh0"].shape[1], w["w_feat"].shape[0]
    U, E = w["w1"].shape[0], w["wx0"].shape[1] - w["w1"].shape[0]
    A = w["w_dec"].shape[0]
    if H % 16:
        raise ValueError(f"the kernel takes dunits % 16 == 0, got {H}")
    Hp, Ep, Up, Op, Ap = H, r16(E), r16(U), r16(O), r16(A)
    M = location_filter(w["att"], bf)

    def mat(m, Kp, Np, gates=False):
        m = m.to(bf)
        if gates:
            m = gate_order(m, H, UB)
        return pack_b(m, Kp, Np, bf, bf)

    wx0 = _rows(w["wx0"].t(), [(0, (0, E)), (Ep, (E, E + U))], Ep + Up)
    w_z = _rows(torch.cat([w["w_feat"], w["w_prob"]]).t(),
                [(0, (0, H)), (Hp, (H, H + E))], Hp + Ep)
    vec = {k: w[k].to(f32).reshape(-1).contiguous()
           for k in ("g", "b_g", "b1", "b2", "b_prob")}
    return PackedAttn(
        H=H, E=E, A=A, U=U, O=O, taps=M.shape[0],
        w_dec=mat(w["w_dec"].t(), Hp, Ap),
        m_loc=mat(M, r16(M.shape[0]), Ap),
        w1=mat(w["w1"].t(), Op, Up), w2=mat(w["w2"].t(), Up, Up),
        wx0=mat(wx0, Ep + Up, 4 * H, gates=True),
        wh0=mat(w["wh0"].t(), Hp, 4 * H, gates=True),
        wx1=mat(w["wx1"].t(), Hp, 4 * H, gates=True),
        wh1=mat(w["wh1"].t(), Hp, 4 * H, gates=True),
        bias0=(w["bx0"].float() + w["bh0"].float()).contiguous(),
        bias1=(w["bx1"].float() + w["bh1"].float()).contiguous(),
        w_z=mat(w_z, Hp + Ep, -(-(O + 1) // 8) * 8), **vec)


_PTRS = ("enc", "pe", "ilens", "lo", "hi", "seed", "w_dec", "m_loc", "g",
         "b_g", "w1", "b1", "w2", "b2", "wx0", "wh0", "wx1", "wh1", "bias0",
         "bias1", "w_z", "b_prob", "hx0", "hx1", "xa", "fa", "state", "q",
         "e", "w_cum", "len", "barrier", "out", "stop", "att", "olens",
         "steps", "kbits")


class AttnArgs(ctypes.Structure):
    """Mirror of ``struct AttnArgs`` in csrc/attn_decode.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in _PTRS]
                + [(n, ctypes.c_int) for n in
                   ("B", "T", "D", "E", "A", "U", "O", "H", "taps")]
                + [(n, ctypes.c_float) for n in
                   ("zoneout", "dropout", "thr_logit")])


class AttnLaunchInfo(ctypes.Structure):
    """Mirror of ``struct AttnLaunchInfo`` in csrc/attn_decode.cu."""
    _fields_ = [(n, ctypes.c_int) for n in
                ("grid", "block_threads", "smem_bytes", "barriers_per_step")]


_ATTN = Entry.kernel("attn_decode", "attn_decode_launch", AttnArgs,
                     AttnLaunchInfo)
last_launch = _ATTN.last  # the newest launch's AttnLaunchInfo


def _launch(pk, enc, pe, ilens, lo, hi, seed, budget, zoneout, dropout,
            thr_logit, with_att):
    """Validate, allocate the outputs and the scratch, launch (counted as
    ``attn_decode``'s)."""
    dev = enc.device
    B, T, E = enc.shape
    A, H, U, O = pk.A, pk.H, pk.U, pk.O
    if B > MAX_ROWS or r16(T) > MAX_POS:
        raise ValueError(f"the kernel takes at most {MAX_ROWS} rows and "
                         f"{MAX_POS} positions, got {B} x {T}")
    if E != pk.E or tuple(pe.shape) != (B, T, A):
        raise ValueError(f"enc {tuple(enc.shape)} / pe {tuple(pe.shape)} do "
                         f"not fit the packed widths E={pk.E}, A={A}")
    Bp, Tp = r16(B), r16(T)
    bf, f32, i32 = torch.bfloat16, torch.float32, torch.int32

    def zeros(n, dtype=f32):
        return torch.zeros(n, dtype=dtype, device=dev)

    ilens = ilens.to(i32)
    w_cum = torch.zeros(B, Tp, device=dev)
    w_cum[:, :T] = initial_weights(ilens, T)
    t = {
        "enc": enc.to(bf).contiguous(), "pe": pe.to(f32).contiguous(),
        "ilens": ilens.contiguous(), "lo": lo.to(i32).contiguous(),
        "hi": hi.to(i32).contiguous(), "seed": seed_tensor(seed, dev),
        "hx0": zeros(2 * Bp * H, bf), "hx1": zeros(2 * Bp * H, bf),
        "xa": zeros(Bp * (r16(E) + r16(U)), bf),
        "fa": zeros(Bp * r16(O), bf), "state": zeros(4 * Bp * H),
        "q": zeros(Bp * r16(A)), "e": zeros(B * Tp), "w_cum": w_cum,
        "len": torch.where(hi.to(i32) <= 0, 0, SENT).to(i32).contiguous(),
        "barrier": zeros(1, i32),
        "out": torch.zeros(B, budget, O, device=dev),
        "stop": torch.zeros(B, budget, device=dev),
        "att": torch.zeros(B, budget, T, device=dev) if with_att else None,
        "olens": zeros(B, i32), "steps": zeros(1, i32),
        "kbits": zeros(2 * Bp * -(-r16(U) // 32), i32),
    }
    for name, x in t.items():
        if x is not None and x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
    ops = dict(pk._asdict(), **t)
    args = struct(AttnArgs, **{n: ops[n] for n in _PTRS}, B=B, T=T, D=budget,
                  E=E, A=A, U=U, O=O, H=H, taps=pk.taps,
                  zoneout=float(zoneout), dropout=float(dropout),
                  thr_logit=float(thr_logit))
    _ATTN.launch(args, device=dev, count=attn_decode,
                 context=f"B={B}, T={T}, H={H}")
    return {k: t[k] for k in ("out", "stop", "att", "olens", "steps")}


def attn_decode(w, enc, pe, ilens, lo, hi, seed, *, budget, zoneout=0.1,
                dropout=0.5, thr_logit=0.0, weights_dtype=torch.bfloat16,
                packed=None, with_att=False):
    """The whole loop: one kernel launch on the card (bf16 weights only),
    ``attn_decode_plain`` on the CPU.  ``packed``: ``pack_attn_weights(w)``
    made once (packed here per call otherwise).  Returns dict(out, stop,
    att (None on the card unless ``with_att``), olens, steps)."""
    if not enc.is_cuda:
        return attn_decode_plain(w, enc, pe, ilens, lo, hi, seed,
                                 budget=budget, zoneout=zoneout,
                                 dropout=dropout, thr_logit=thr_logit,
                                 weights_dtype=weights_dtype)
    if weights_dtype != torch.bfloat16:
        raise ValueError(f"the kernel takes bf16 weights, got "
                         f"{weights_dtype}")
    for name, x in (("pe", pe), ("ilens", ilens), ("lo", lo), ("hi", hi)):
        if not x.is_cuda:
            raise ValueError(f"mixed devices: {name} is not on the card")
    if packed is None:
        packed = pack_attn_weights(w)
    return _launch(packed, enc, pe, ilens, lo, hi, seed, budget, zoneout,
                   dropout, thr_logit, with_att)


attn_decode.launches = 0
