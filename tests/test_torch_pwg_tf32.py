"""The numerics and the schedule of ``csrc/pwg_stream.cu``, emulated on the
CPU and held to the port's plain versions.

- Precision: the kernel splits every product operand into TF32 halves
  (hi: the fp32 mantissa truncated to 10 bits; lo: x - hi, exact in fp32,
  truncated likewise; x ~ hi + lo to 2^-20) and sums a_lo.b_hi +
  a_hi.b_lo + a_hi.b_hi in fp32 (3xTF32).  Run through the plain
  version's algorithm at PWG v1 widths, that stays within the card's 1e-4
  of the fp32 plain version; the error of a single TF32 pass is printed
  beside it for the record.
- Schedule: a NumPy replay of the kernel's data movement (a ping-pong
  buffer of one time tile between layers, each layer's history in two
  buffers alternating by tile parity, read from the state at the first tile
  and written to it after the last, the skip sums in a ring, x_0 of the
  next tile written in the head phase), with a time tile that does not
  divide the chunk, equal to ``pwg_stream_step_plain`` on wav and state.

CPU only, no JAX.
"""

import math

import numpy as np
import pytest
import torch

from fcl_taco2_tpu_torch.vocoder import pwg_cuda as PC
from fcl_taco2_tpu_torch.vocoder.pwg import (ParallelWaveGAN, PWGConfig,
                                             upsample_mel)

TOL_PWG = 1e-4  # the card's limit for the kernel against the plain version


def trunc_tf32(x):
    """fp32 -> TF32 (10 mantissa bits) toward zero, the low 13 bits
    cleared, as the kernel's ``split``; kept in an fp32 container."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split_tf32(x):
    hi = trunc_tf32(x)
    return hi, trunc_tf32(x - hi)


def matmul_3xtf32(a, b):
    """a @ b as the kernel computes it: the three TF32 products summed in
    one fp32 accumulation (products of TF32 values are exact in fp32)."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return torch.cat([al, ah, ah], dim=-1) @ torch.cat([bh, bl, bh], dim=0)


def matmul_1xtf32(a, b):
    return trunc_tf32(a) @ trunc_tf32(b)


def test_tf32_split_is_exact_in_its_parts():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4096, generator=g) * torch.exp(
        torch.randn(4096, generator=g) * 4)
    hi, lo = split_tf32(x)
    for part in (hi, lo):
        assert (part.view(torch.int32) & 0x1FFF).eq(0).all()
    assert torch.equal(x - hi, (x.double() - hi.double()).float())
    assert ((x - hi).abs() < x.abs() * 2.0 ** -10).all()
    assert ((x - hi - lo).abs() < x.abs() * 2.0 ** -20).all()
    # toward zero on both signs
    y = torch.tensor([1 + 2.0 ** -10 + 2.0 ** -12, -(1 + 2.0 ** -10
                                                    + 2.0 ** -12)])
    assert trunc_tf32(y).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10)]


def _oneshot(model, cfg, mel, noise, matmul, T=256):
    """pwg_generate_streaming_plain with the products in ``matmul``."""
    B, Tm, _ = mel.shape
    W = Tm * cfg.hop
    delay = PC._round8(PC.total_delay(cfg))
    Wp = -(-(W + delay) // T) * T
    aux = torch.nn.functional.pad(upsample_mel(model, cfg, mel),
                                  (0, 0, 0, Wp - W))
    noise_p = torch.nn.functional.pad(noise, (0, Wp - W))
    state = PC.pwg_stream_state(cfg, B, device="cpu")
    wav, _ = PC._stream_plain(PC.pack_pwg_weights(model, cfg), cfg, state,
                              aux, noise_p, 0, W, T, matmul=matmul)
    return wav[:, delay:delay + W]


@torch.no_grad()
def test_3xtf32_products_hold_the_kernels_limit_at_pwg_v1_widths():
    cfg = PWGConfig(layers=6, stacks=2)  # PWG v1 widths: 64/128/64, aux 80
    assert (cfg.residual_channels, cfg.gate_channels, cfg.skip_channels,
            cfg.aux_channels) == (64, 128, 64, 80)
    model = ParallelWaveGAN(cfg, device="cpu", seed=0)
    rng = np.random.default_rng(0)
    Tm = 8
    mel = torch.from_numpy(
        rng.normal(size=(1, Tm, cfg.aux_channels)).astype(np.float32))
    noise = torch.from_numpy(
        rng.normal(size=(1, Tm * cfg.hop)).astype(np.float32))
    want = PC.pwg_generate_streaming_plain(model, cfg, mel, noise, tile=256)
    assert torch.equal(_oneshot(model, cfg, mel, noise, torch.matmul), want)
    err3 = (_oneshot(model, cfg, mel, noise, matmul_3xtf32)
            - want).abs().max().item()
    err1 = (_oneshot(model, cfg, mel, noise, matmul_1xtf32)
            - want).abs().max().item()
    print(f"\nvs the fp32 plain version (output scale "
          f"{want.abs().max().item():.3e}): 3xTF32 max abs err {err3:.3e}, "
          f"one TF32 pass {err1:.3e} (limit {TOL_PWG:g})")
    assert np.isfinite(err3) and err3 < TOL_PWG
    assert err3 < err1


def test_weights_are_packed_in_the_kernels_fragment_order():
    """w1k / w2k hold, for k step s, warp w and lane 4g + t, the m16n8k8 B
    fragments of the warp's 8 columns and their partners 64 on."""
    cfg = PWGConfig(layers=2, stacks=1)
    packed = PC.pack_pwg_weights(ParallelWaveGAN(cfg, device="cpu", seed=3),
                                 cfg)
    for w, wk in ((packed.w1, packed.w1k), (packed.w2, packed.w2k)):
        L, K, N = w.shape
        assert N == 128 and K % 8 == 0
        assert wk.shape == (L, K // 8, 8, 32, 4)
        for s in range(K // 8):
            for warp in range(8):
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    c = 8 * warp + g
                    want = torch.stack([w[:, 8 * s + t, c],
                                        w[:, 8 * s + t + 4, c],
                                        w[:, 8 * s + t, 64 + c],
                                        w[:, 8 * s + t + 4, 64 + c]], dim=1)
                    assert torch.equal(wk[:, s, warp, lane], want)


# ----------------------------------------------------------------------
# the kernel's schedule, replayed in NumPy
# ----------------------------------------------------------------------

def kernel_schedule(packed, cfg, state, aux, noise, start, W, N, tile):
    """csrc/pwg_stream.cu's data movement for one launch over positions
    [start, start + N), in float64.  ``state`` None is the one-shot entry
    (zero state in, none out).  Unwritten scratch is NaN, so a read of a
    row the kernel has not written shows in the result."""
    pk = {k: v.double().numpy() for k, v in packed._asdict().items()}
    aux = aux.double().numpy()
    noise = noise.double().numpy()
    B, n_aux, _ = aux.shape
    n_noise = noise.shape[1]
    C, S = cfg.residual_channels, cfg.skip_channels
    half = cfg.gate_channels // 2
    L = cfg.layers
    dils = list(cfg.dilations)
    cums = np.cumsum(dils)
    bws = [PC._buf_width(d) for d in dils]
    offs = np.concatenate([[0], np.cumsum(bws)[:-1]])
    sum_bw = sum(bws)
    delay = PC._round8(PC.total_delay(cfg))
    ra = PC._pow2_at_least(tile + delay)
    if state is not None:
        ah_in = state["aux_hist"].double().numpy()
        acc_in = state["acc"].double().numpy()
        bufs_in = torch.cat(state["bufs"], dim=1).double().numpy()
        bufs_out = np.full((B, sum_bw, C), np.nan)
    else:
        ah_in = acc_in = bufs_in = bufs_out = None

    def aux_rows(q):  # (B, len(q), A): aux, the state's history, or zero
        j = q - start
        out = np.zeros((B, len(q), aux.shape[2]))
        now = (j >= 0) & (j < n_aux)
        out[:, now] = aux[:, j[now]]
        if ah_in is not None:
            past = j < 0
            out[:, past] = ah_in[:, j[past] + delay]
        return out

    ring = np.zeros((B, ra, S))
    if acc_in is not None:
        ring[:, (start + np.arange(delay)) % ra] = acc_in
    xbuf = np.full((2, B, tile, C), np.nan)
    hbuf = np.full((2, B, sum_bw, C), np.nan)
    wav = np.full((B, N), np.nan)

    def first_conv(s0, n):
        p = s0 + np.arange(n)
        j = p - start
        nz = np.zeros((B, n))
        ok = j < n_noise
        nz[:, ok] = noise[:, j[ok]]
        x = nz[..., None] * pk["first_w"] + pk["first_b"]
        xbuf[0, :, :n] = np.where((p < W)[None, :, None], x, 0.0)

    end = start + N
    first_conv(start, min(tile, N))
    t, s0 = 0, start
    while s0 < end:
        n = min(tile, end - s0)
        last = s0 + tile >= end
        hread = bufs_in if t == 0 else hbuf[t & 1]
        hwrite = bufs_out if last else hbuf[(t + 1) & 1]
        p = s0 + np.arange(n)
        for i in range(L):
            d, cum, bw, off = dils[i], int(cums[i]), bws[i], int(offs[i])
            cur = xbuf[i & 1]

            def x_at(q):  # x_i at positions q: this tile or the history
                now = q >= s0
                out = np.zeros((B, len(q), C))
                out[:, now] = cur[:, q[now] - s0]
                if hread is not None:
                    out[:, ~now] = hread[:, off + bw - (s0 - q[~now])]
                return out

            if hwrite is not None:
                hwrite[:, off:off + bw] = x_at(s0 + n - bw + np.arange(bw))
            a = np.concatenate([x_at(p - 2 * d), x_at(p - d), x_at(p),
                                aux_rows(p - cum)], axis=-1)
            h = a @ pk["w1"][i][:a.shape[-1]] + pk["b1"][i]
            g = np.tanh(h[..., :half]) / (1 + np.exp(-h[..., half:]))
            gs = g @ pk["w2"][i]
            slots = (p + delay - cum) % ra
            ring[:, slots] = ring[:, slots] + gs[..., :S] + pk["b2"][i, :S]
            if i + 1 < L:
                x = (gs[..., S:] + pk["b2"][i, S:] + a[..., C:2 * C]) \
                    * math.sqrt(0.5)
                keep = (p >= cum) & (p < W + cum)
                xbuf[(i + 1) & 1, :, :n] = np.where(keep[None, :, None], x,
                                                    0.0)
        slots = p % ra
        z = np.maximum(ring[:, slots] * math.sqrt(1.0 / L), 0.0)
        ring[:, slots] = 0.0
        z = np.maximum(z @ pk["last1_w"] + pk["last1_b"], 0.0)
        wav[:, s0 - start:s0 - start + n] = z @ pk["last2_w"] + pk["last2_b"]
        if not last:
            first_conv(s0 + tile, min(tile, end - s0 - tile))
        t, s0 = t + 1, s0 + tile
    if state is None:
        return wav, None
    new_state = {
        "aux_hist": aux_rows(end - delay + np.arange(delay)),
        "acc": ring[:, (end + np.arange(delay)) % ra],
        "bufs": np.split(bufs_out, np.cumsum(bws)[:-1], axis=1)}
    return wav, new_state


# small widths; dilations up to 64, so a layer's history (128 rows) is
# longer than the time tiles below and partly carried from older tiles
SCHED_CFG = dict(layers=7, stacks=1, residual_channels=8, gate_channels=16,
                 skip_channels=8, aux_channels=5, upsample_scales=(2, 2))


def _sched_setup(B=2, Tm=40, seed=0):
    cfg = PWGConfig(**SCHED_CFG)
    model = ParallelWaveGAN(cfg, device="cpu", seed=seed)
    rng = np.random.default_rng(seed)
    mel = torch.from_numpy(
        rng.normal(size=(B, Tm, cfg.aux_channels)).astype(np.float32))
    noise = torch.from_numpy(
        rng.normal(size=(B, Tm * cfg.hop)).astype(np.float32))
    return cfg, model, mel, noise


@pytest.mark.parametrize("tile", [24, 1000])
def test_schedule_replay_matches_plain_oneshot(tile):
    cfg, model, mel, noise = _sched_setup()
    W = mel.shape[1] * cfg.hop
    delay = PC._round8(PC.total_delay(cfg))
    want = PC.pwg_generate_streaming_plain(model, cfg, mel, noise, tile=16)
    with torch.no_grad():
        aux = upsample_mel(model, cfg, mel)
    got, _ = kernel_schedule(PC.pack_pwg_weights(model, cfg), cfg, None, aux,
                             noise, 0, W, W + delay, tile)
    np.testing.assert_allclose(got[:, delay:delay + W], want.numpy(),
                               atol=1e-5)


@pytest.mark.parametrize("tile", [24, 64])
def test_schedule_replay_matches_plain_stream_steps(tile):
    """Chained chunks of 64 samples: a 24-sample tile does not divide the
    chunk (a partial last tile in every launch); 64 is one tile a launch."""
    cfg, model, mel, noise = _sched_setup(seed=1)
    B, Tm, _ = mel.shape
    W = Tm * cfg.hop
    delay = PC._round8(PC.total_delay(cfg))
    Vh = 64
    n = -(-(W + delay) // Vh)
    with torch.no_grad():
        aux = torch.zeros(B, n * Vh, cfg.aux_channels)
        aux[:, :W] = upsample_mel(model, cfg, mel)
    nz = torch.zeros(B, n * Vh)
    nz[:, :W] = noise
    packed = PC.pack_pwg_weights(model, cfg)
    st = PC.pwg_stream_state(cfg, B, device="cpu")
    for j in range(n):
        sl = slice(j * Vh, (j + 1) * Vh)
        got, got_st = kernel_schedule(packed, cfg, st, aux[:, sl], nz[:, sl],
                                      j * Vh, W, Vh, tile)
        want, st = PC.pwg_stream_step_plain(packed, cfg, st, aux[:, sl],
                                            nz[:, sl], j * Vh, W, tile=16)
        np.testing.assert_allclose(got, want.numpy(), atol=1e-5)
        for a, b in zip([got_st["aux_hist"], got_st["acc"],
                         *got_st["bufs"]],
                        [st["aux_hist"], st["acc"], *st["bufs"]]):
            assert a.shape == tuple(b.shape)
            np.testing.assert_allclose(a, b.numpy(), atol=1e-5)
