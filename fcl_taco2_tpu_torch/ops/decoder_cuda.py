"""Fused AR decoder loop as one CUDA kernel for Hopper (port of
``fcl_taco2_tpu/ops/decoder_pallas.py``).

Two wrappers keep the Pallas entry points' names and arguments:

- ``fused_ar_decode``: the resident entry.  The kernel also computes the
  step-invariant ``enc @ wx0_enc + bx0`` and ``enc @ wf_enc`` (as
  ``_kernel`` does).  Weights fp32 or bf16.
- ``fused_ar_decode_hbm``: the streaming entry.  The enc projections are
  hoisted out as two plain GEMMs (as ``decoder_pallas.py:438-440``); the
  recurrent matrices wh0, wx1, wh1 are fp32, bf16 or per-column int8
  codes.

Both launch ``csrc/ar_decode.cu`` once per call (the whole step loop runs
on the device) for CUDA tensors, and run their plain PyTorch versions,
``*_plain``, for CPU tensors.  There is no fallback: a CUDA tensor either
launches the kernel or raises.  The kernel takes its weights packed
(``pack_decoder_weights``: B-fragment order, gate columns grouped by the
units each block owns); pass ``packed=`` to pack once.  ``dec_params`` is
the decoder's weights in the JAX layout
(``models.decoder.Decoder.jax_layout``).

The prenet dropout stays on at inference.  The kernel draws it from a
counter-based Philox keyed on (seed, row, step, layer, unit); the plain
versions draw from a ``torch.Generator`` seeded with ``seed``.  The two
streams differ, so kernel and plain version agree only at dropout 0, and
the kernel's draws are checked by their statistics
(``dropout_keep_mask``).  ``seed`` is an int32 tensor of one element, as
the Pallas kernels' ``seed_ref``: the kernel reads it on the device, so a
CUDA graph that draws the seed and launches the kernel replays a fresh
seed each time (an int is taken too, outside a capture).  The plain
versions read it on the host.

Each wrapper launches through ``utils/cuda_build.py``, which fills
``last_launch`` and counts the wrapper's launches (``fn.launches``): a
launch inside a capture is counted by the graph, once per replay.
"""

import ctypes
from typing import NamedTuple, Optional

import torch

from fcl_taco2_tpu_torch.ops.rnn import prenet_dropout
from fcl_taco2_tpu_torch.utils.cuda_build import (Entry, operand, r16,
                                                  seed_tensor, seed_value,
                                                  struct)

TILE = 128  # rows per ragged step bound; the kernel reads bounds[row // TILE]

# The entry policy's size line (models/taco2_sa.py::decode_segments):
# configs whose decoder weights total at most this many bytes in fp32 take
# the resident entry with fp32 weights (the student, 5.8 MB), the others
# the streaming entry with bf16 or int8 (the teacher, 63 MB in fp32).
# Either way the kernel holds each block's share of the recurrent matrices
# in shared memory across the steps where the shares fit (the grid's 132
# SMs hold ~30 MB together), and streams them from global memory where
# they do not (teacher weights in fp32).
L2_RESIDENT_BYTES = 25 * 1024 * 1024


def tile_step_bounds(flat_dur):
    """Per-tile AR step bounds for the ragged decode: the max duration in
    each TILE-row group of ``flat_dur``.  Every caller builds bounds
    through this helper, so the bound groups always match the kernel's."""
    P = flat_dur.shape[0]
    n_tiles = -(-P // TILE)
    padded = torch.zeros(n_tiles * TILE, dtype=torch.int32,
                         device=flat_dur.device)
    padded[:P] = flat_dur.to(torch.int32)
    return padded.view(n_tiles, TILE).amax(dim=1)


def decoder_weight_bytes(cfg, weights_dtype=torch.float32):
    """Bytes of the AR loop's weight matrices (prenet, lstm0/1, feat_out)."""
    H, idim, units, odim = (cfg.dunits, cfg.dec_idim, cfg.prenet_units,
                            cfg.odim)
    n = (odim * units + units * units + (idim + units + 1) * 4 * H
         + 3 * H * 4 * H + (H + idim) * odim)
    return torch.empty((), dtype=weights_dtype).element_size() * n


def fits_l2(cfg, weights_dtype=torch.float32):
    """True when the decoder weights in ``weights_dtype`` are within
    ``L2_RESIDENT_BYTES``: the entry policy's test (the student at 256-d
    in fp32 passes, the teacher at 1024-d, ~63 MB in fp32, does not)."""
    return decoder_weight_bytes(cfg, weights_dtype) <= L2_RESIDENT_BYTES


def hbm_stream_compatible(cfg):
    """Config gate for fused_ar_decode_hbm: reference topology + the
    recurrent width of ``decoder_pallas.py:338-343``."""
    return (cfg.prenet_layers == 2 and cfg.append_position
            and cfg.use_concate and cfg.dlayers == 2
            and cfg.reduction_factor == 1 and cfg.dunits % 256 == 0)


def quantize_per_column(w):
    """Symmetric per-output-column int8: ``w ~= codes * scale[None, :]``,
    codes in [-127, 127], round half to even (as ``jnp.round``)."""
    s = w.abs().amax(dim=0).float() / 127.0
    s = torch.clamp(s, min=1e-30)  # dead columns: codes stay 0
    q = torch.clamp(torch.round(w.float() / s), -127, 127)
    return q.to(torch.int8), s


def prequantize_hbm_weights(dec_params, compute_dtype=torch.float32):
    """One-time int8 codes for ``fused_ar_decode_hbm(prequant=...)``:
    ``(wbig_q (3H, 4H) int8, scales (3, 4H) fp32)`` for wh0, wx1, wh1,
    cast to ``compute_dtype`` first (as synthesize casts before the
    kernel quantizes)."""
    big = [dec_params["lstm0"]["wh"], dec_params["lstm1"]["wx"],
           dec_params["lstm1"]["wh"]]
    qs = [quantize_per_column(w.to(compute_dtype)) for w in big]
    return (torch.cat([q for q, _ in qs], dim=0),
            torch.stack([s for _, s in qs]))


def maybe_prequantize(cfg, dec_params, quantize):
    """Serving-wrapper init hook: int8 codes when ``quantize == "int8"``
    and the config can ride the streaming entry, else None."""
    if quantize != "int8" or not hbm_stream_compatible(cfg):
        return None
    dt = getattr(torch, cfg.compute_dtype)
    with torch.no_grad():
        return prequantize_hbm_weights(dec_params, compute_dtype=dt)


# --------------------------------------------------------------------------
# weight slicing shared by the kernels and the plain versions
# --------------------------------------------------------------------------

_RESIDENT = ("pre_w1", "pre_w2", "wx0_pre", "wx0_pos", "wf_z")
_STREAMED = ("wh0", "wx1", "wh1")
_MATRICES = _RESIDENT + _STREAMED + ("wx0_enc", "wf_enc")


def _split(dec_params, idim):
    pre = dec_params["prenet"]["layers"]
    units, odim = pre[0]["w"].shape[1], pre[0]["w"].shape[0]
    wx0 = dec_params["lstm0"]["wx"]
    H = dec_params["lstm0"]["wh"].shape[0]
    wf = dec_params["feat_out"]["w"]
    return {
        "units": units, "odim": odim, "H": H,
        "pre_w1": pre[0]["w"], "pre_b1": pre[0]["b"],
        "pre_w2": pre[1]["w"], "pre_b2": pre[1]["b"],
        "wx0_enc": wx0[:idim], "wx0_pre": wx0[idim:idim + units],
        "wx0_pos": wx0[idim + units],
        "bx0": dec_params["lstm0"]["bx"], "bh0": dec_params["lstm0"]["bh"],
        "wh0": dec_params["lstm0"]["wh"],
        "wx1": dec_params["lstm1"]["wx"], "bx1": dec_params["lstm1"]["bx"],
        "wh1": dec_params["lstm1"]["wh"], "bh1": dec_params["lstm1"]["bh"],
        "wf_z": wf[:H], "wf_enc": wf[H:],
    }


def _mm(a, w, act_dtype):
    """The Pallas kernels' ``mm``: activations cast to the weight dtype,
    products accumulated in fp32 (int8 codes ride as exact bf16)."""
    return a.to(act_dtype).float() @ w.float()


def _row_bounds(bounds, P, D, device):
    if bounds is None:
        return torch.full((P,), D, dtype=torch.int64, device=device)
    b = bounds.to(device=device, dtype=torch.int64).repeat_interleave(TILE)
    return torch.clamp(b[:P], max=D)


def _ar_loop_plain(w, enc_gates, enc_out, position, seed, zoneout, dropout,
                   bounds, act_dtype, big, scales):
    """The step loop of both kernels in PyTorch ops.  ``big`` holds (wh0,
    wx1, wh1) as stored (fp32, bf16 or int8 codes); ``scales`` their
    per-column scales (3, 4H) for int8, else None."""
    P, D = position.shape
    dev = position.device
    H, odim = w["H"], w["odim"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed_value(seed))
    row_bound = _row_bounds(bounds, P, D, dev)
    n_steps = int(row_bound.max()) if P else 0
    keep = 1.0 - zoneout
    f32 = torch.float32

    def stream(m, h):
        acc = _mm(h, big[m], act_dtype)
        return acc if scales is None else acc * scales[m].float()

    def lstm_half(gates, h, c):
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        return zoneout * h + keep * h_new, zoneout * c + keep * c_new

    h0 = c0 = h1 = c1 = torch.zeros(P, H, dtype=f32, device=dev)
    prev = torch.zeros(P, odim, dtype=f32, device=dev)
    out = torch.zeros(P, D, odim, dtype=f32, device=dev)
    wpos = w["wx0_pos"].float()
    for t in range(n_steps):
        p = torch.relu(_mm(prev, w["pre_w1"], act_dtype)
                       + w["pre_b1"].float())
        p = prenet_dropout(p, dropout, gen)
        p = torch.relu(_mm(p, w["pre_w2"], act_dtype) + w["pre_b2"].float())
        p = prenet_dropout(p, dropout, gen)
        gates0 = (enc_gates + _mm(p, w["wx0_pre"], act_dtype)
                  + position[:, t, None].float() * wpos
                  + stream(0, h0) + w["bh0"].float())
        h0, c0 = lstm_half(gates0, h0, c0)
        gates1 = (w["bx1"].float() + w["bh1"].float()
                  + stream(1, h0) + stream(2, h1))
        h1, c1 = lstm_half(gates1, h1, c1)
        prev = _mm(h1, w["wf_z"], act_dtype) + enc_out
        out[:, t] = prev * (t < row_bound)[:, None].to(f32)
    return out


def fused_ar_decode_plain(dec_params, enc_seg, position, seed, *,
                          zoneout=0.1, dropout=0.5,
                          weights_dtype=torch.float32, bounds=None):
    """Plain PyTorch version of ``fused_ar_decode`` (same casts)."""
    w = _split(dec_params, enc_seg.shape[1])
    wd = {k: (v.to(weights_dtype) if k in _MATRICES else v)
          for k, v in w.items()}
    enc_gates = _mm(enc_seg, wd["wx0_enc"], weights_dtype) + w["bx0"].float()
    enc_out = _mm(enc_seg, wd["wf_enc"], weights_dtype)
    return _ar_loop_plain(wd, enc_gates, enc_out, position, seed, zoneout,
                          dropout, bounds, weights_dtype,
                          (wd["wh0"], wd["wx1"], wd["wh1"]), None)


def _hbm_weights(dec_params, idim, weights_dtype, prequant):
    """Resident weights in rdt, the three streamed matrices (wh0, wx1,
    wh1) and their int8 scales (or None) as the streaming entry takes them
    (``decoder_pallas.py:431-453``)."""
    quantized = weights_dtype == torch.int8
    rdt = torch.bfloat16 if quantized else weights_dtype
    w = _split(dec_params, idim)
    wd = {k: (v.to(rdt) if k in _RESIDENT else v) for k, v in w.items()}
    if not quantized:
        return wd, rdt, tuple(w[k].to(rdt) for k in _STREAMED), None
    if prequant is None:
        prequant = prequantize_hbm_weights(dec_params,
                                           compute_dtype=w["wh0"].dtype)
    wbig, scales = prequant
    H = w["H"]
    return wd, rdt, (wbig[:H], wbig[H:2 * H], wbig[2 * H:]), scales


def _hoisted_enc(enc_seg, w):
    """The streaming entry's hoisted GEMMs, fp32 (plain PyTorch, as XLA)."""
    enc = enc_seg.float()
    return (enc @ w["wx0_enc"].float() + w["bx0"].float(),
            enc @ w["wf_enc"].float())


def fused_ar_decode_hbm_plain(dec_params, enc_seg, position, seed, *,
                              zoneout=0.1, dropout=0.5,
                              weights_dtype=torch.bfloat16, bounds=None,
                              prequant=None):
    """Plain PyTorch version of ``fused_ar_decode_hbm`` (same casts)."""
    wd, rdt, big, scales = _hbm_weights(dec_params, enc_seg.shape[1],
                                        weights_dtype, prequant)
    enc_gates, enc_out = _hoisted_enc(enc_seg, wd)
    return _ar_loop_plain(wd, enc_gates, enc_out, position, seed, zoneout,
                          dropout, bounds, rdt, big, scales)


# --------------------------------------------------------------------------
# the kernel's operand layout
# --------------------------------------------------------------------------

# A lane's four values of one k16 step (lane = 4 * gid + t, column gid of an
# n8 tile): the rows of a weight fragment and the columns of an activation
# fragment, by the type multiplied in.  bf16 (m16n8k16): 2t, 2t+1, 2t+8,
# 2t+9; fp32 (3xTF32, two m16n8k8 steps): t, t+4, t+8, t+12.
_KIDX = {
    torch.bfloat16: torch.tensor([[2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9]
                                  for t in range(4)]),
    torch.float32: torch.tensor([[t, t + 4, t + 8, t + 12]
                                 for t in range(4)]),
}


def _act_dtype(wdt):
    """The type activations are multiplied in: fp32 for fp32 weights,
    bf16 for bf16 weights and int8 codes."""
    return torch.float32 if wdt == torch.float32 else torch.bfloat16


def act_positions(K, act_dtype):
    """Where logical column k (< K, K a multiple of 16) of an activation
    row sits in the kernel's fragment-ordered layout (``apos`` in
    csrc/ar_decode.cu): lane t's four values of a k16 step are adjacent."""
    kidx = _KIDX[act_dtype].reshape(-1)  # position 4t + e -> column
    pos = torch.empty(16, dtype=torch.int64)
    pos[kidx] = torch.arange(16)
    return (torch.arange(K) // 16) * 16 + pos[torch.arange(K) % 16]


def pack_b(w, Kp, Np, dtype, act_dtype):
    """A (K, N) weight matrix as the kernel's B operand: zero-padded to
    (Kp, Np) (Kp a multiple of 16, Np of 8), cast to ``dtype``, in fragment
    order (Np / 8, Kp / 16, 32, 4): [n-tile, k16 step, lane 4 gid + t,
    value e] = w[16 step + KIDX[t, e], 8 n-tile + gid]."""
    K, N = w.shape
    full = torch.zeros(Kp, Np, dtype=w.dtype, device=w.device)
    full[:K, :N] = w
    kidx = _KIDX[act_dtype].to(w.device)
    v = full.view(Kp // 16, 16, Np // 8, 8)[:, kidx]  # (kg, t, e, nt, gid)
    v = v.permute(3, 0, 4, 1, 2).reshape(Np // 8, Kp // 16, 32, 4)
    return v.to(dtype).contiguous()


def gate_order(w, H, ub):
    """Columns of an LSTM gate matrix (K, 4H), gates (i, f, g, o) of unit j
    at g * H + j, in the kernel's slice order: slice b holds units
    [b ub, (b + 1) ub) of the padded width Hp, unit-major with the four
    gates together (column 4 ub b + 4 u + g); padded units are zero.  A
    cluster of two blocks owns slices 2p and 2p + 1, each block one K
    half of both."""
    K = w.shape[0]
    Hp = r16(H)
    out = torch.zeros(K, Hp, 4, dtype=w.dtype, device=w.device)
    out[:, :H] = w.view(K, 4, H).transpose(1, 2)
    return out.reshape(K, 4 * Hp)


def units_per_block(H, device=None):
    """Hidden units a block owns: the fewest (2, 4 or 8) that give one
    block a slice on the card (``Hp / ub`` <= the SM count), 8 where none
    does (the blocks then take several slices, streamed).  H100: 2 for the
    student (128 slices), 8 for the teacher (128 slices)."""
    sms = 132
    if device is not None and torch.device(device).type == "cuda":
        sms = torch.cuda.get_device_properties(device).multi_processor_count
    for ub in (2, 4, 8):
        if r16(H) // ub <= sms:
            return ub
    return 8


class PackedDecoder(NamedTuple):
    """The decoder's AR-loop weights as the kernel takes them, made once by
    ``pack_decoder_weights`` (``wdt``: prenet, wx0_pre, wf_z and the enc
    projections; ``bdt``: wh0, wx1, wh1, int8 codes or ``wdt``).  Packed
    matrices (``*k``) are in ``pack_b``'s fragment order with K padded to
    16; the gate matrices' columns in ``gate_order`` for ``ub`` units a
    block.  Vectors are fp32; ``wx0_pos`` holds the ``wdt``-rounded
    weights.  ``wx0_enc``/``wf_enc`` are kept as given for the streaming
    entry's hoisted fp32 GEMMs."""
    weights_dtype: torch.dtype
    wdt: torch.dtype
    bdt: torch.dtype
    idim: int
    units: int
    odim: int
    H: int
    ub: int
    w1k: torch.Tensor
    pre_b1: torch.Tensor
    w2k: torch.Tensor
    pre_b2: torch.Tensor
    wx0k: torch.Tensor
    wx0_pos: torch.Tensor
    bh0: torch.Tensor
    wh0k: torch.Tensor
    wx1k: torch.Tensor
    wh1k: torch.Tensor
    bx1: torch.Tensor
    bh1: torch.Tensor
    wfk: torch.Tensor
    wx0ek: torch.Tensor
    bx0: torch.Tensor
    wfek: torch.Tensor
    scales: Optional[torch.Tensor]
    wx0_enc: torch.Tensor
    wf_enc: torch.Tensor


def pack_decoder_weights(dec_params, idim, weights_dtype, prequant=None,
                         ub=None):
    """Pack the decoder's weights once for both kernel entries.

    ``weights_dtype``: torch.float32 or torch.bfloat16 (every matrix in
    it), or torch.int8 (wh0, wx1, wh1 as per-column codes, from
    ``prequant`` when given, the rest bf16; the streaming entry only).
    ``ub``: units a block (default ``units_per_block`` on the weights'
    device)."""
    if weights_dtype not in (torch.float32, torch.bfloat16, torch.int8):
        raise ValueError(f"weights_dtype {weights_dtype} not supported")
    w = _split(dec_params, idim)
    quantized = weights_dtype == torch.int8
    wdt = torch.bfloat16 if quantized else weights_dtype
    adt = _act_dtype(wdt)
    H, U, O = w["H"], w["units"], w["odim"]
    Hp, Up, Op, Ip = r16(H), r16(U), r16(O), r16(idim)
    dev = w["wh0"].device
    ub = units_per_block(H, dev) if ub is None else ub
    if ub not in (2, 4, 8):
        raise ValueError(f"ub must be 2, 4 or 8, got {ub}")
    f32 = torch.float32

    def mat(m, Kp, Np, dtype=wdt, gates=False):
        m = m.to(dtype)
        if gates:
            m = gate_order(m, H, ub)
        return pack_b(m, Kp, Np, dtype, adt)

    scales = None
    if quantized:
        if prequant is None:
            prequant = prequantize_hbm_weights(
                dec_params, compute_dtype=w["wh0"].dtype)
        wbig, scales = prequant
        big = (wbig[:H], wbig[H:2 * H], wbig[2 * H:])
        scales = scales.to(f32).contiguous()
        bdt = torch.int8
    else:
        big = (w["wh0"], w["wx1"], w["wh1"])
        bdt = wdt
    wh0k, wx1k, wh1k = (mat(m, Hp, 4 * Hp, bdt, gates=True) for m in big)
    vec = {k: w[k].to(f32).contiguous()
           for k in ("pre_b1", "pre_b2", "bh0", "bx1", "bh1", "bx0")}
    return PackedDecoder(
        weights_dtype=weights_dtype, wdt=wdt, bdt=bdt, idim=idim, units=U,
        odim=O, H=H, ub=ub,
        w1k=mat(w["pre_w1"], Op, Up), w2k=mat(w["pre_w2"], Up, Up),
        wx0k=mat(w["wx0_pre"], Up, 4 * Hp, gates=True),
        wx0_pos=w["wx0_pos"].to(wdt).to(f32).contiguous(),
        wh0k=wh0k, wx1k=wx1k, wh1k=wh1k,
        wfk=mat(w["wf_z"], Hp, Op),
        wx0ek=mat(w["wx0_enc"], Ip, r16(4 * H)),
        wfek=mat(w["wf_enc"], Ip, Op), scales=scales,
        wx0_enc=w["wx0_enc"], wf_enc=w["wf_enc"], **vec)


# --------------------------------------------------------------------------
# the CUDA launch
# --------------------------------------------------------------------------

_PTR_FIELDS = ("enc", "enc_gates", "enc_out", "pos", "bounds", "w1k",
               "pre_b1", "w2k", "pre_b2", "wx0k", "wx0_pos", "bh0",
               "wh0k", "wx1k", "wh1k", "bx1", "bh1", "wfk", "wx0ek", "bx0",
               "wfek", "scales", "out", "scratch", "barrier", "trace",
               "seed")


class DecodeArgs(ctypes.Structure):
    """Mirror of ``struct DecodeArgs`` in csrc/ar_decode.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in _PTR_FIELDS]
                + [(n, ctypes.c_int) for n in
                   ("P", "D", "idim", "odim", "units", "H", "ragged",
                    "resident", "quantized", "units_per_block")]
                + [("zoneout", ctypes.c_float), ("dropout", ctypes.c_float)])


class LaunchInfo(ctypes.Structure):
    """Mirror of ``struct LaunchInfo`` in csrc/ar_decode.cu."""
    _fields_ = [(n, ctypes.c_int) for n in (
        "grid", "block_threads", "units_per_block", "stationary",
        "smem_bytes", "barriers_per_step", "prologue_barriers", "cluster",
        "cooperative", "captured")]


_WKIND = {(torch.float32, torch.float32): 0,
          (torch.bfloat16, torch.bfloat16): 1,
          (torch.bfloat16, torch.int8): 2}
_AR_DECODE = Entry.kernel("ar_decode", "ar_decode_launch", DecodeArgs,
                          LaunchInfo, kind=True)
_DROPOUT_MASK = Entry("ar_decode", "dropout_mask_launch",
                      [ctypes.c_uint, ctypes.c_float, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p])

# The newest launch, as the launcher reported it: grid (blocks),
# block_threads, units_per_block, stationary (1: weight slices in shared
# memory for the whole launch; 0: streamed from global memory each step),
# smem_bytes (dynamic, a block), barriers_per_step, prologue_barriers,
# cluster (blocks), cooperative (1: the driver took a cooperative launch
# with clusters; 0: residency rests on the occupancy check alone),
# captured (1: the launch went into a CUDA graph capture).
last_launch = _AR_DECODE.last


def _scratch_bytes(pk, P):
    """The kernel's scratch (csrc/ar_decode.cu, the kernel's prologue):
    activations in their product type (enc, p2, h0 and h1 twice each) and
    fp32 h0, c0, h1, c1, over P rounded up to 32 rows."""
    Pp = -(-P // 32) * 32
    Hp = r16(pk.H)
    n_act = Pp * (r16(pk.idim) + r16(pk.units) + 4 * Hp)
    asize = 4 if _act_dtype(pk.wdt) == torch.float32 else 2
    return n_act * asize + 4 * Pp * Hp * 4


def _launch(pk, *, resident, tensors, P, D, bounds, zoneout, dropout, seed,
            trace=None, count=None):
    """Validate the per-call operands and the pack, allocate the output and
    scratch, launch (counted as a launch of ``count``, the wrapper, when
    given).  ``trace``: an int64 tensor of (D + 1) x 7 x 132 entries (or
    more) gets each block's phase times (csrc/ar_decode.cu, ``mark``)."""
    dev = tensors["pos"].device
    H, U, O, I = pk.H, pk.units, pk.odim, pk.idim
    G, Hp, Up, Op, Ip = 4 * H, r16(H), r16(U), r16(O), r16(I)
    f32 = torch.float32

    def frag(Kp, Np, dtype):
        return ((Np // 8, Kp // 16, 32, 4), dtype)

    shapes = {
        "pos": ((P, D), f32), "enc_gates": ((P, G), f32),
        "enc_out": ((P, O), f32),
        "w1k": frag(Op, Up, pk.wdt), "pre_b1": ((U,), f32),
        "w2k": frag(Up, Up, pk.wdt), "pre_b2": ((U,), f32),
        "wx0k": frag(Up, 4 * Hp, pk.wdt), "wx0_pos": ((G,), f32),
        "bh0": ((G,), f32), "wh0k": frag(Hp, 4 * Hp, pk.bdt),
        "wx1k": frag(Hp, 4 * Hp, pk.bdt), "wh1k": frag(Hp, 4 * Hp, pk.bdt),
        "bx1": ((G,), f32), "bh1": ((G,), f32),
        "wfk": frag(Hp, Op, pk.wdt),
    }
    if resident:
        shapes.update({"enc": ((P, I), f32),
                       "wx0ek": frag(Ip, r16(G), pk.wdt),
                       "bx0": ((G,), f32), "wfek": frag(Ip, Op, pk.wdt)})
    if pk.bdt == torch.int8:
        shapes["scales"] = ((3, G), f32)
    if bounds is not None:
        shapes["bounds"] = ((-(-P // TILE),), torch.int32)
    ops = dict(pk._asdict(), **tensors, bounds=bounds)
    for name, (shape, dtype) in shapes.items():
        operand(ops[name], name, shape, dtype, dev)

    out = torch.empty(P, D, O, dtype=f32, device=dev)
    scratch = torch.empty(_scratch_bytes(pk, P), dtype=torch.uint8,
                          device=dev)
    barrier = torch.zeros(1, dtype=torch.int32, device=dev)
    args = struct(DecodeArgs, **{n: ops[n] for n in shapes}, out=out,
                  scratch=scratch, barrier=barrier, trace=trace,
                  seed=seed_tensor(seed, dev), P=P, D=D, idim=I, odim=O,
                  units=U, H=H, ragged=int(bounds is not None),
                  resident=int(resident), quantized=int(pk.bdt == torch.int8),
                  units_per_block=pk.ub, zoneout=float(zoneout),
                  dropout=float(dropout))
    _AR_DECODE.launch(args, _WKIND[(pk.wdt, pk.bdt)], device=dev,
                      count=count, context=f"P={P}, H={H}")
    return out


def _require_cuda_operands(*ts):
    for t in ts:
        if t is not None and not t.is_cuda:
            raise ValueError("mixed devices: the CUDA kernel needs every "
                             "operand on the card")


def _check_pack(pk, weights_dtype, device):
    if pk.weights_dtype != weights_dtype:
        raise ValueError(f"packed weights are {pk.weights_dtype}, the call "
                         f"asks for {weights_dtype}")
    if pk.w1k.device != device:
        raise ValueError(f"packed weights are on {pk.w1k.device}, "
                         f"expected {device}")


def fused_ar_decode(dec_params, enc_seg, position, seed, *, zoneout=0.1,
                    dropout=0.5, weights_dtype=torch.float32, bounds=None,
                    packed=None):
    """Run the whole AR loop in one kernel launch (resident entry).

    Args:
        dec_params: decoder weights in the JAX layout.
        enc_seg: (P, idim) per-segment conditioning vectors.
        position: (P, D) position ramps.
        seed: the prenet dropout's seed, a (1,) int32 tensor (or an
            int) read on the device.
        weights_dtype: torch.float32 or torch.bfloat16 for the weight
            matrices (biases, state and accumulation stay fp32).
        bounds: optional (ceil(P/TILE),) int32 per-tile step bounds.
        packed: optional ``pack_decoder_weights(dec_params, idim,
            weights_dtype)`` made once; packed here per call otherwise.
    Returns:
        (P, D, odim) float32 frames; frames at or past a row's tile bound
        are zero (valid frames are selected by the caller).
    """
    if not enc_seg.is_cuda:
        return fused_ar_decode_plain(
            dec_params, enc_seg, position, seed, zoneout=zoneout,
            dropout=dropout, weights_dtype=weights_dtype, bounds=bounds)
    if weights_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"weights_dtype {weights_dtype} not supported")
    _require_cuda_operands(position, bounds)
    P, idim = enc_seg.shape
    D = position.shape[1]
    if packed is None:
        packed = pack_decoder_weights(dec_params, idim, weights_dtype)
    _check_pack(packed, weights_dtype, enc_seg.device)
    if P == 0:
        return torch.zeros(0, D, packed.odim, device=enc_seg.device)
    f32 = torch.float32
    t = {"enc": enc_seg.to(f32).contiguous(),
         "pos": position.to(f32).contiguous(),
         "enc_gates": torch.empty(P, 4 * packed.H, dtype=f32,
                                  device=enc_seg.device),
         "enc_out": torch.empty(P, packed.odim, dtype=f32,
                                device=enc_seg.device)}
    return _launch(packed, resident=True, tensors=t, P=P, D=D,
                   bounds=bounds, zoneout=zoneout, dropout=dropout, seed=seed,
                   count=fused_ar_decode)


fused_ar_decode.launches = 0


def fused_ar_decode_hbm(dec_params, enc_seg, position, seed, *, zoneout=0.1,
                        dropout=0.5, weights_dtype=torch.bfloat16,
                        bounds=None, prequant=None, packed=None):
    """AR decoder loop, streaming entry (the teacher): same kernel, the enc
    projections hoisted outside as two plain fp32 GEMMs, the recurrent
    matrices wh0, wx1, wh1 in ``weights_dtype`` — fp32, bf16, or
    ``torch.int8`` per-column codes (``prequant`` from
    ``prequantize_hbm_weights`` skips the inline quantization).  ``packed``
    (``pack_decoder_weights``, made once) skips the per-call packing.
    Returns (P, D, odim) float32 frames, zero at or past a row's tile
    bound."""
    if not enc_seg.is_cuda:
        return fused_ar_decode_hbm_plain(
            dec_params, enc_seg, position, seed, zoneout=zoneout,
            dropout=dropout, weights_dtype=weights_dtype, bounds=bounds,
            prequant=prequant)
    if weights_dtype not in (torch.float32, torch.bfloat16, torch.int8):
        raise ValueError(f"weights_dtype {weights_dtype} not supported")
    _require_cuda_operands(position, bounds,
                           *(prequant if prequant is not None else ()))
    P, idim = enc_seg.shape
    D = position.shape[1]
    if packed is None:
        packed = pack_decoder_weights(dec_params, idim, weights_dtype,
                                      prequant=prequant)
    _check_pack(packed, weights_dtype, enc_seg.device)
    if P == 0:
        return torch.zeros(0, D, packed.odim, device=enc_seg.device)
    enc_gates, enc_out = _hoisted_enc(enc_seg, packed._asdict())
    t = {"pos": position.to(torch.float32).contiguous(),
         "enc_gates": enc_gates.contiguous(),
         "enc_out": enc_out.contiguous()}
    return _launch(packed, resident=False, tensors=t, P=P, D=D,
                   bounds=bounds, zoneout=zoneout, dropout=dropout, seed=seed,
                   count=fused_ar_decode_hbm)


fused_ar_decode_hbm.launches = 0


def dropout_keep_mask(seed, rate, rows, units, *, step=0, layer=0,
                      device="cuda"):
    """The kernel's prenet dropout mask for one (step, layer), computed by
    the same device function the decode uses: (rows, units) float32 of
    0 or 1/(1-rate).  CUDA only; for statistics checks."""
    out = torch.empty(rows, units, dtype=torch.float32, device=device)
    if not out.is_cuda:
        raise ValueError("dropout_keep_mask runs the CUDA kernel only")
    _DROPOUT_MASK.launch(int(seed) & 0xFFFFFFFF, float(rate), rows, units,
                         step, layer, out.data_ptr(), device=out.device,
                         context=f"{rows} x {units}")
    return out
