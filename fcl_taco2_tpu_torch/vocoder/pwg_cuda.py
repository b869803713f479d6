"""Streaming Parallel-WaveGAN generator as one CUDA kernel for Hopper (port
of ``fcl_taco2_tpu/vocoder/pwg_pallas.py``).

Causal reformulation (as the Pallas kernel): each 'same'-padded dilated
conv (kernel 3, dilation d) is re-indexed as a causal conv whose output
stream lags by d.  Layer i reads its input stream at positions p - 2d,
p - d and p, the mel conditioning at p - cum_i (cum_i = d_0 + .. + d_i),
and adds its skip output into an accumulator at p + delay - cum_i, so all
skips align at ``delay = _round8(total_delay(cfg))`` samples.  Masking
each layer's stream to its valid window [cum_i, W + cum_i) reproduces the
graph's zero padding on both edges, so the emitted stream equals
``pwg_generate`` delayed by ``delay``; the caller trims.

Two entries keep the Pallas names, arguments and trim/pad conventions:

- ``pwg_generate_streaming``: one-shot, zero state, position 0.
- ``pwg_stream_step``: one chunk of the sample stream with the state
  (aux history, skip accumulator, one ring of past inputs per layer) in
  and out, in the JAX state's layout (``pwg_stream_state``).  Chained
  steps equal the one-shot call.  Its stream position comes as ints or as
  one (2,) int32 tensor ``(start, W)`` (``stream_pos``), which the kernel
  reads on the device, as the Pallas kernel reads ``start_ref``: a CUDA
  graph of a stream step then replays at the position written before the
  replay.  The one-shot entry's position is static (0 and the shapes'
  W), like its shapes.

Both launch ``csrc/pwg_stream.cu`` once per call for CUDA tensors and run
their plain PyTorch versions (``*_plain``, the same tile-by-tile ring
algorithm as ``pwg_pallas.py:149-178``) for CPU tensors.  There is no
fallback: a CUDA tensor launches the kernel or raises (through
``utils/cuda_build.py``, which fills ``last_launch`` and counts each
entry's launches, ``fn.launches``).  Inputs, outputs,
state and sums are fp32, as the Pallas kernel computes; the kernel runs
its products on the TF32 tensor cores at fp32 accuracy (3xTF32: each
operand truncated into TF32 halves, x ~ hi + lo to 2^-20, and
a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi summed in fp32), the plain
versions in plain fp32 matmuls.
"""

import ctypes
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from fcl_taco2_tpu_torch.utils.cuda_build import Entry, operand, struct
from fcl_taco2_tpu_torch.utils.device import resolve_device
from fcl_taco2_tpu_torch.vocoder.pwg import (PWGConfig, pwg_generate_chunked,
                                             upsample_mel)

KC = 8      # the kernel's contraction step (m16n8k8): the gate K pads to it
ROWS_PER_PHASE = 16384  # B * (kernel time tile) per grid-wide phase
MAX_LAYERS = 64


def total_delay(cfg: PWGConfig) -> int:
    return int(sum(cfg.dilations))


def _round8(x):
    return -(-x // 8) * 8


def _buf_width(d):
    """Per-layer history width: the 2d the taps need, at least 8 (the
    JAX state's layout)."""
    return max(8, 2 * d)


class PackedPWG(NamedTuple):
    """The generator's weights as the kernel takes them, fp32:

    w1 (L, K1p, G): rows [t*C + c] tap t of the dilated conv, rows
        [3C + a] the aux 1x1, zero rows up to K1p (a multiple of KC);
    b1 (L, G); w2 (L, G/2, S + C) = [skip | out]; b2 (L, S + C);
    first_w, first_b (C,); last1_w (S, S) as (in, out); last1_b (S,);
    last2_w (S,); last2_b (1,);
    w1k (L, K1p / 8, 8, 32, 4): w1 in the kernel's order, the m16n8k8 B
        fragments of each k step s, warp w and lane 4g + t:
        [w1[8s+t, 8w+g], w1[8s+t+4, 8w+g], w1[8s+t, G/2+8w+g],
        w1[8s+t+4, G/2+8w+g]] (tanh columns, then their sigmoid partners);
    w2k (L, G/16, 8, 32, 4): w2 in the same order (skip columns, then the
        out columns).
    """
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    first_w: torch.Tensor
    first_b: torch.Tensor
    last1_w: torch.Tensor
    last1_b: torch.Tensor
    last2_w: torch.Tensor
    last2_b: torch.Tensor
    w1k: torch.Tensor
    w2k: torch.Tensor


def pack_pwg_weights(params, cfg: PWGConfig) -> PackedPWG:
    """Pre-pack a ``ParallelWaveGAN``'s weights into the kernel operands;
    shared by both entries and their plain versions, so pack once and
    reuse across ``pwg_stream_step`` calls."""
    C, A = cfg.residual_channels, cfg.aux_channels
    K1 = 3 * C + A
    K1p = -(-K1 // KC) * KC
    f32 = torch.float32
    with torch.no_grad():
        w1, b1, w2, b2 = [], [], [], []
        for blk in params.conv_layers:
            taps = blk.conv.weight.to(f32).permute(2, 1, 0)  # (3, C, G)
            aux = blk.conv1x1_aux.weight.to(f32)[:, :, 0].t()  # (A, G)
            w1.append(F.pad(torch.cat([taps.reshape(3 * C, -1), aux]),
                            (0, 0, 0, K1p - K1)))
            b1.append(blk.conv.bias.to(f32))
            w2.append(torch.cat([blk.conv1x1_skip.weight.to(f32)[:, :, 0].t(),
                                 blk.conv1x1_out.weight.to(f32)[:, :, 0].t()],
                                dim=1))
            b2.append(torch.cat([blk.conv1x1_skip.bias.to(f32),
                                 blk.conv1x1_out.bias.to(f32)]))
        last1, last2 = params.last_conv_layers[1], params.last_conv_layers[3]
        w1, w2 = torch.stack(w1), torch.stack(w2)
        return PackedPWG(*(t.detach().contiguous() for t in (
            w1, torch.stack(b1), w2,
            torch.stack(b2), params.first_conv.weight.to(f32)[:, 0, 0],
            params.first_conv.bias.to(f32), last1.weight.to(f32)[:, :, 0].t(),
            last1.bias.to(f32), last2.weight.to(f32)[0, :, 0],
            last2.bias.to(f32), _fragment_order(w1), _fragment_order(w2))))


def _fragment_order(w):
    """(L, K, 128) -> the kernel's (L, K/8, 8, 32, 4) B-fragment order
    (``PackedPWG.w1k``, ``.w2k``); empty for widths the kernel does not
    take (it needs 128 columns: 8 warps x 8 columns x 2)."""
    L, K, N = w.shape
    if N != 128 or K % KC:
        return w.new_empty(0)
    # k = 8s + 4 half + t, column = 64 j + 8 w + g
    x = w.reshape(L, K // 8, 2, 4, 2, 8, 8)  # L s half t j w g
    return x.permute(0, 1, 5, 6, 3, 4, 2).reshape(L, K // 8, 8, 32, 4)


def pwg_stream_state(cfg: PWGConfig, B: int = 1, device="cuda"):
    """Zero cross-call stream state (a fresh stream), the JAX state's
    arrays and shapes (``pwg_pallas.py:254-263``)."""
    dev = resolve_device(device)
    delay = _round8(total_delay(cfg))
    z = dict(dtype=torch.float32, device=dev)
    return {
        "aux_hist": torch.zeros(B, delay, cfg.aux_channels, **z),
        "acc": torch.zeros(B, delay, cfg.skip_channels, **z),
        "bufs": tuple(torch.zeros(B, _buf_width(d), cfg.residual_channels,
                                  **z) for d in cfg.dilations),
    }


# ----------------------------------------------------------------------
# plain PyTorch versions: the Pallas kernel's tile loop
# ----------------------------------------------------------------------

def _stream_plain(packed, cfg, state, aux, noise, start, W, T,
                  matmul=torch.matmul):
    """Tiles of T positions over [start, start + N), state in and out
    (``pwg_pallas.py:282-336``).  aux (B, N, A), noise (B, N), N % T == 0.
    ``matmul`` computes every product (a numerics emulation may stand in
    for the fp32 default)."""
    B, N, A = aux.shape
    C, S = cfg.residual_channels, cfg.skip_channels
    half = cfg.gate_channels // 2
    delay = _round8(total_delay(cfg))
    ah = state["aux_hist"].float()
    acc = torch.cat([state["acc"].float(), aux.new_zeros(B, T, S)], dim=1)
    bufs = [b.float() for b in state["bufs"]]
    rows = torch.arange(T, device=aux.device)
    outs = []
    for t in range(N // T):
        tile = slice(t * T, (t + 1) * T)
        aux_ext = torch.cat([ah, aux[:, tile]], dim=1)
        ah = aux_ext[:, T:]
        pos = (start + t * T + rows)[None, :, None]
        x = noise[:, tile, None] * packed.first_w + packed.first_b
        x = torch.where(pos < W, x, 0.0)
        cum = 0
        for i, d in enumerate(cfg.dilations):
            cum += d
            bw = _buf_width(d)
            inp = torch.cat([bufs[i], x], dim=1)  # (B, bw + T, C)
            bufs[i] = inp[:, T:]
            base = bw - 2 * d
            off = delay - cum
            w1 = packed.w1[i]
            h = (matmul(inp[:, base:base + T], w1[:C])
                 + matmul(inp[:, base + d:base + d + T], w1[C:2 * C])
                 + matmul(inp[:, base + 2 * d:base + 2 * d + T],
                          w1[2 * C:3 * C])
                 + matmul(aux_ext[:, off:off + T], w1[3 * C:3 * C + A])
                 + packed.b1[i])
            g = torch.tanh(h[..., :half]) * torch.sigmoid(h[..., half:])
            gs = matmul(g, packed.w2[i])
            acc[:, off:off + T] = (acc[:, off:off + T] + gs[..., :S]
                                   + packed.b2[i, :S])
            x = (gs[..., S:] + packed.b2[i, S:]
                 + inp[:, base + d:base + d + T]) * math.sqrt(0.5)
            x = torch.where((pos >= cum) & (pos < W + cum), x, 0.0)
        z = torch.relu(acc[:, :T] * math.sqrt(1.0 / cfg.layers))
        acc = torch.cat([acc[:, T:], acc.new_zeros(B, T, S)], dim=1)
        z = torch.relu(matmul(z, packed.last1_w) + packed.last1_b)
        outs.append(z @ packed.last2_w + packed.last2_b)
    return torch.cat(outs, dim=1), {"aux_hist": ah, "acc": acc[:, :delay],
                                    "bufs": tuple(bufs)}


def _check_oneshot(cfg, mel, noise):
    B, Tm, _ = mel.shape
    W = Tm * cfg.hop
    if tuple(noise.shape) != (B, W):
        raise ValueError(f"noise has shape {tuple(noise.shape)}, expected "
                         f"{(B, W)}")
    return B, W


@torch.no_grad()
def pwg_generate_streaming_plain(params, cfg: PWGConfig, mel, noise,
                                 tile: int = 1024, packed=None):
    """Plain PyTorch version of ``pwg_generate_streaming``."""
    B, W = _check_oneshot(cfg, mel, noise)
    delay = _round8(total_delay(cfg))
    T = tile
    Wp = -(-(W + delay) // T) * T
    aux = F.pad(upsample_mel(params, cfg, mel.float()), (0, 0, 0, Wp - W))
    noise_p = F.pad(noise.float(), (0, Wp - W))
    state = pwg_stream_state(cfg, B, device=mel.device)
    if packed is None:
        packed = pack_pwg_weights(params, cfg)
    wav, _ = _stream_plain(packed, cfg, state, aux, noise_p, 0, W, T)
    return wav[:, delay:delay + W]


def _check_step(aux, noise, tile):
    B, Vh, _ = aux.shape
    if Vh % tile:
        raise ValueError(f"chunk of {Vh} samples is not a multiple of the "
                         f"tile {tile}")
    if tuple(noise.shape) != (B, Vh):
        raise ValueError(f"noise has shape {tuple(noise.shape)}, expected "
                         f"{(B, Vh)}")


def stream_pos(start, W, device):
    """The stream position as the kernel reads it: (2,) int32 ``(start,
    W)`` on ``device``."""
    return torch.tensor([int(start), int(W)], dtype=torch.int32,
                        device=device)


def _pos_values(start, W):
    """(start, W) as host ints from ints or a (2,) tensor (a host read)."""
    if torch.is_tensor(start):
        if W is not None or tuple(start.shape) != (2,):
            raise ValueError("a tensor stream position is (2,): (start, W)")
        return tuple(int(v) for v in start.tolist())
    return int(start), int(W)


@torch.no_grad()
def pwg_stream_step_plain(packed, cfg: PWGConfig, state, aux, noise, start,
                          W=None, tile: int = 1024):
    """Plain PyTorch version of ``pwg_stream_step``."""
    _check_step(aux, noise, tile)
    start, W = _pos_values(start, W)
    return _stream_plain(packed, cfg, state, aux.float(), noise.float(),
                         start, W, tile)


# ----------------------------------------------------------------------
# the CUDA launch
# ----------------------------------------------------------------------

_PTR_FIELDS = ("noise", "aux", "w1k", "b1", "w2k", "b2", "first_w",
               "first_b", "last1_w", "last1_b", "last2_w", "last2_b",
               "ah_in", "acc_in", "bufs_in", "wav", "ah_out", "acc_out",
               "bufs_out", "xbuf", "hbuf", "ring_acc", "pos")
_INT_FIELDS = ("B", "N", "n_aux", "n_noise", "start", "W", "A", "K1p", "L",
               "delay", "tile", "ra", "sum_bw")
_LAYER_FIELDS = ("dil", "cum", "bw", "buf_off")


class PwgArgs(ctypes.Structure):
    """Mirror of ``struct PwgArgs`` in csrc/pwg_stream.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in _PTR_FIELDS]
                + [(n, ctypes.c_int) for n in _INT_FIELDS]
                + [("z_scale", ctypes.c_float)]
                + [(n, ctypes.c_int * MAX_LAYERS) for n in _LAYER_FIELDS])


class PwgLaunchInfo(ctypes.Structure):
    """Mirror of ``struct PwgLaunchInfo`` in csrc/pwg_stream.cu."""
    _fields_ = [(n, ctypes.c_int) for n in ("grid", "block_rows",
                                            "block_tiles", "barriers",
                                            "groups", "smem_bytes")]


_PWG = Entry.kernel("pwg_stream", "pwg_stream_launch", PwgArgs,
                    PwgLaunchInfo)
last_launch = _PWG.last  # the newest launch's PwgLaunchInfo


def _pow2_at_least(n):
    return 1 << max(0, int(n - 1).bit_length())


def kernel_tile(B, N):
    """The kernel's time tile: about ROWS_PER_PHASE rows (B x positions)
    per grid-wide phase, a multiple of 64, at most N rounded up."""
    rows = max(64, ROWS_PER_PHASE // B // 64 * 64)
    return min(rows, -(-N // 64) * 64)


def _launch(packed, cfg, aux, noise, start, W, N, state, count=None):
    """Validate, allocate the output, the scratch and the state out,
    launch (counted as a launch of ``count``, the entry, when given).
    aux (B, n_aux, A) covers positions [start, start + n_aux), noise
    (B, n_noise) likewise; both read as zero past their ends.  ``start``
    may be a (2,) int32 tensor ``(start, W)`` on the card (``W`` None),
    read by the kernel."""
    C, G, S, A = (cfg.residual_channels, cfg.gate_channels,
                  cfg.skip_channels, cfg.aux_channels)
    L = cfg.layers
    if (C, G, S) != (64, 128, 64) or A % 4 or A > 128 or L > MAX_LAYERS:
        raise ValueError(
            "the CUDA kernel takes residual and skip channels 64, gate "
            f"channels 128, aux channels a multiple of 4 up to 128 and at "
            f"most {MAX_LAYERS} layers; got {(C, G, S, A, L)}")
    dev = aux.device
    B, n_aux = aux.shape[0], aux.shape[1]
    n_noise = noise.shape[1]
    K1p = packed.w1.shape[1]
    delay = _round8(total_delay(cfg))
    dils = cfg.dilations
    bws = [_buf_width(d) for d in dils]
    sum_bw = sum(bws)
    shapes = {"noise": (B, n_noise), "aux": (B, n_aux, A),
              "w1k": (L, K1p // KC, 8, 32, 4), "b1": (L, G),
              "w2k": (L, G // 2 // KC, 8, 32, 4),
              "b2": (L, S + C), "first_w": (C,), "first_b": (C,),
              "last1_w": (S, S), "last1_b": (S,), "last2_w": (S,),
              "last2_b": (1,)}
    t = {"noise": noise, "aux": aux, **packed._asdict()}
    if state is not None:
        shapes.update({"ah_in": (B, delay, A), "acc_in": (B, delay, S),
                       "bufs_in": (B, sum_bw, C)})
        t.update({"ah_in": state["aux_hist"], "acc_in": state["acc"],
                  "bufs_in": torch.cat([b.to(torch.float32)
                                        for b in state["bufs"]], dim=1)})
    # the kernel reads rows as 16-byte vectors
    t = {k: operand(t[k], k, shp, torch.float32, dev, cast=True,
                    align16=True) for k, shp in shapes.items()}
    if torch.is_tensor(start):
        if W is not None or tuple(start.shape) != (2,) \
                or start.dtype != torch.int32 or start.device != dev:
            raise ValueError(f"the stream position must be a (2,) int32 "
                             f"tensor (start, W) on {dev}")
        t["pos"], start, W = start, 0, 0

    tile = kernel_tile(B, N)
    ra = _pow2_at_least(tile + delay)
    f32 = dict(dtype=torch.float32, device=dev)
    t["wav"] = torch.empty(B, N, **f32)
    t["xbuf"] = torch.empty(2, B, tile, C, **f32)
    t["hbuf"] = torch.empty(2, B, sum_bw, C, **f32)
    t["ring_acc"] = torch.empty(B, ra, S, **f32)
    if state is not None:
        t["ah_out"] = torch.empty(B, delay, A, **f32)
        t["acc_out"] = torch.empty(B, delay, S, **f32)
        t["bufs_out"] = torch.empty(B, sum_bw, C, **f32)
    cum = [sum(dils[:i + 1]) for i in range(L)]
    offs = [sum(bws[:i]) for i in range(L)]
    layer = {n: (ctypes.c_int * MAX_LAYERS)(*v)
             for n, v in zip(_LAYER_FIELDS, (dils, cum, bws, offs))}
    args = struct(PwgArgs, **t, B=B, N=N, n_aux=n_aux, n_noise=n_noise,
                  start=int(start), W=int(W), A=A, K1p=K1p, L=L, delay=delay,
                  tile=tile, ra=ra, sum_bw=sum_bw, z_scale=math.sqrt(1.0 / L),
                  **layer)
    _PWG.launch(args, device=dev, count=count,
                context=f"B={B}, N={N}, tile={tile}")
    new_state = None
    if state is not None:
        new_state = {"aux_hist": t["ah_out"], "acc": t["acc_out"],
                     "bufs": tuple(t["bufs_out"].split(bws, dim=1))}
    return t["wav"], new_state


@torch.no_grad()
def pwg_generate_streaming(params, cfg: PWGConfig, mel, noise,
                           tile: int = 1024, packed=None):
    """mel (B, Tm, aux), noise (B, Tm*hop) -> wav (B, Tm*hop)
    (``pwg_pallas.py:181-236``).

    One kernel launch for CUDA tensors, the plain version for CPU ones.
    Exact (fp reassociation only) against ``pwg_generate`` over the whole
    utterance, tail included.  ``tile`` is the plain version's time tile;
    the kernel picks its own (``kernel_tile``), which does not change the
    result.  ``packed``: ``pack_pwg_weights(params, cfg)`` made once by the
    caller; packed here when not given."""
    if packed is None:
        packed = pack_pwg_weights(params, cfg)
    if not mel.is_cuda:
        return pwg_generate_streaming_plain(params, cfg, mel, noise, tile,
                                            packed=packed)
    B, W = _check_oneshot(cfg, mel, noise)
    delay = _round8(total_delay(cfg))
    aux = upsample_mel(params, cfg, mel.float())
    wav, _ = _launch(packed, cfg, aux, noise, 0, W, W + delay, None,
                     count=pwg_generate_streaming)
    return wav[:, delay:delay + W]


pwg_generate_streaming.launches = 0


@torch.no_grad()
def pwg_stream_step(packed, cfg: PWGConfig, state, aux, noise, start,
                    W=None, tile: int = 1024):
    """One streaming-vocoder call over a chunk of the sample stream
    (``pwg_pallas.py:339-422``).

    Args:
        packed: ``pack_pwg_weights`` output.
        state: ``pwg_stream_state`` or the previous call's new state.
        aux: (B, Vh, aux_channels) upsampled conditioning for stream
            positions [start, start + Vh); rows at positions >= W must be
            zero (the one-shot path's zero padding).
        noise: (B, Vh) input noise for the same positions (content past
            W is ignored: the kernel masks it).
        start: stream position of aux[:, 0]; W: the stream's real sample
            count (frames * hop); or ``start`` a (2,) int32 tensor
            ``(start, W)`` (``stream_pos``) and ``W`` None: the kernel
            reads it on the device (the plain version on the host).
        tile: Vh must be a multiple of it (the Pallas tile); the kernel
            picks its own time tile.

    Returns (wav (B, Vh), new_state).  Positions [delay, delay + W) carry
    the audio (delay = ``_round8(total_delay(cfg))``); the caller trims.
    Chained calls over [0, ceil((W + delay) / Vh) * Vh) equal
    ``pwg_generate_streaming``.
    """
    if not aux.is_cuda:
        return pwg_stream_step_plain(packed, cfg, state, aux, noise, start,
                                     W, tile)
    _check_step(aux, noise, tile)
    return _launch(packed, cfg, aux, noise, start, W, aux.shape[1], state,
                   count=pwg_stream_step)


pwg_stream_step.launches = 0


@torch.no_grad()
def vocode(params, cfg: PWGConfig, mel, noise, backend: str = "auto",
           tile: int = 1024, packed=None):
    """Vocode dispatch (``pwg_pallas.py:425-440``): ``auto`` is the
    streaming kernel for CUDA tensors and the exact chunked conv graph
    (``pwg_generate_chunked``, the JAX package's ``xla`` path) for CPU
    tensors; ``pallas`` is always ``pwg_generate_streaming`` (the plain
    version on the CPU), with ``packed`` weights when given.  Same (B, W)
    output either way."""
    if backend == "auto":
        backend = "pallas" if mel.is_cuda else "xla"
    if backend == "pallas":
        return pwg_generate_streaming(params, cfg, mel, noise, tile=tile,
                                      packed=packed)
    if backend != "xla":
        raise ValueError(f"backend must be 'auto', 'pallas' or 'xla', got "
                         f"{backend!r}")
    # one-sided receptive field: the conv stack (total_delay samples) plus
    # the mel-grid context of conv_in and the upsample smoothing convs
    ctx = (-(-total_delay(cfg) // cfg.hop) + cfg.aux_context_window
           + sum(cfg.upsample_scales) + 1)
    return pwg_generate_chunked(params, cfg, mel, noise, chunk_frames=128,
                                context_frames=ctx)
