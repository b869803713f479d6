"""The port's CUDA kernels on the card: each against its plain version,
the kernel's dropout statistics, and synthesize's routing through the
kernels.  Marked ``cuda``; they skip where no GPU is present.  This file
imports no JAX, so it also runs on a GPU host without it:
``python -m pytest -m cuda --noconftest tests/test_torch_port_cuda.py``."""

import numpy as np
import pytest
import torch

from fcl_taco2_tpu_torch.models.config import ModelConfig

pytestmark = pytest.mark.cuda


def tiny_config(**kw):
    """tests/helpers.py::tiny_config, in the port's config."""
    base = dict(
        idim=11, odim=8, embed_dim=16, eunits=16, econv_layers=2,
        econv_chans=16, econv_filts=5, dlayers=2, dunits=20,
        prenet_layers=2, prenet_units=12, postnet_layers=3, postnet_chans=10,
        postnet_filts=5, duration_predictor_chans=14,
        pitch_predictor_chans=14, energy_predictor_chans=14,
        max_dur=6, compute_dtype="float32")
    base.update(kw)
    return ModelConfig(**base)


TOL_F32 = 1e-4   # fp32 sums in another order, over the AR steps
TOL_BF16 = 2e-3  # a flipped bf16 activation rounding carried by feedback


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the kernels have no "
                    "CPU mode)")
    return torch.device("cuda")


def _inputs(cfg, P, dev, seed=0):
    from fcl_taco2_tpu_torch.ops import decoder_cuda as K
    g = torch.Generator().manual_seed(seed)
    dur = torch.randint(0, cfg.max_dur + 1, (P,), generator=g)
    dur, _ = torch.sort(dur, descending=True)
    d = torch.arange(cfg.max_dur)[None, :]
    fm = d < dur[:, None]
    pos = torch.where(fm, d / dur[:, None].clamp(min=1), 0.0)
    enc = torch.randn(P, cfg.dec_idim, generator=g)
    return (enc.to(dev), pos.float().to(dev), fm.to(dev),
            K.tile_step_bounds(dur.to(dev)))


@pytest.mark.parametrize("ragged", [False, True])
def test_kernels_match_plain_versions(cuda, ragged):
    from fcl_taco2_tpu_torch.models.decoder import Decoder
    from fcl_taco2_tpu_torch.ops import decoder_cuda as K

    cfg = tiny_config(dunits=256, dropout_rate=0.0, max_dur=9)
    dp = Decoder(cfg, device=cuda).jax_layout()
    enc, pos, fm, bounds = _inputs(cfg, 130, cuda)
    bounds = bounds if ragged else None
    with torch.no_grad():
        for fn, plain, wdt, tol in (
                (K.fused_ar_decode, K.fused_ar_decode_plain,
                 torch.float32, TOL_F32),
                (K.fused_ar_decode, K.fused_ar_decode_plain,
                 torch.bfloat16, TOL_BF16),
                (K.fused_ar_decode_hbm, K.fused_ar_decode_hbm_plain,
                 torch.bfloat16, TOL_BF16),
                (K.fused_ar_decode_hbm, K.fused_ar_decode_hbm_plain,
                 torch.int8, TOL_BF16)):
            n0 = fn.launches
            kw = dict(zoneout=0.1, dropout=0.0, weights_dtype=wdt,
                      bounds=bounds)
            got = fn(dp, enc, pos, 0, **kw)
            want = plain(dp, enc, pos, 0, **kw)
            assert fn.launches == n0 + 1
            err = ((got - want) * fm[..., None]).abs().max().item()
            assert err < tol, (fn.__name__, wdt, err)
            if ragged:  # frames at or past the tile bound are exact zeros
                rows = K._row_bounds(bounds, 130, cfg.max_dur, cuda)
                past = torch.arange(cfg.max_dur, device=cuda)[None] \
                    >= rows[:, None]
                assert (got[past] == 0).all()


@pytest.mark.parametrize("P", [16, 100])
def test_kernels_match_plain_versions_at_small_and_odd_P(cuda, P):
    """P = 16 (one row tile) and P = 100 (not a multiple of the 32-row
    padding or of 64), ragged, with packed weights made once."""
    from fcl_taco2_tpu_torch.models.decoder import Decoder
    from fcl_taco2_tpu_torch.ops import decoder_cuda as K

    cfg = tiny_config(dunits=256, dropout_rate=0.0, max_dur=9)
    dp = Decoder(cfg, device=cuda).jax_layout()
    enc, pos, fm, bounds = _inputs(cfg, P, cuda, seed=P)
    with torch.no_grad():
        for fn, plain, wdt, tol in (
                (K.fused_ar_decode, K.fused_ar_decode_plain,
                 torch.float32, TOL_F32),
                (K.fused_ar_decode_hbm, K.fused_ar_decode_hbm_plain,
                 torch.int8, TOL_BF16)):
            pk = K.pack_decoder_weights(dp, cfg.dec_idim, wdt)
            kw = dict(zoneout=0.1, dropout=0.0, weights_dtype=wdt,
                      bounds=bounds)
            got = fn(dp, enc, pos, 0, packed=pk, **kw)
            assert K.last_launch["barriers_per_step"] <= 3
            want = plain(dp, enc, pos, 0, **kw)
            err = ((got - want) * fm[..., None]).abs().max().item()
            assert err < tol, (fn.__name__, wdt, P, err)


def test_streamed_mode_matches_plain_version(cuda):
    """Teacher widths in fp32 (426 KB of gate slices a block): the kernel
    reads its weights from global memory each step."""
    from fcl_taco2_tpu_torch.models import teacher_config
    from fcl_taco2_tpu_torch.models.decoder import Decoder
    from fcl_taco2_tpu_torch.ops import decoder_cuda as K

    cfg = teacher_config(11, odim=80, dropout_rate=0.0, max_dur=12)
    dp = Decoder(cfg, device=cuda).jax_layout()
    enc, pos, fm, bounds = _inputs(cfg, 96, cuda)
    kw = dict(zoneout=0.1, dropout=0.0, weights_dtype=torch.float32,
              bounds=bounds)
    with torch.no_grad():
        got = K.fused_ar_decode_hbm(dp, enc, pos, 0, **kw)
        assert K.last_launch["stationary"] == 0
        want = K.fused_ar_decode_hbm_plain(dp, enc, pos, 0, **kw)
    err = ((got - want) * fm[..., None]).abs().max().item()
    assert err < TOL_F32, err


def test_kernel_dropout_statistics(cuda):
    from fcl_taco2_tpu_torch.ops import decoder_cuda as K
    for rate in (0.1, 0.5, 0.9):
        m = K.dropout_keep_mask(5, rate, 1024, 1024, device=cuda)
        keep = (m > 0).float().mean().item()
        assert abs(keep - (1 - rate)) < 5e-3, (rate, keep)
        kept = m[m > 0]
        torch.testing.assert_close(kept, torch.full_like(kept,
                                                         1 / (1 - rate)))
    a = K.dropout_keep_mask(5, 0.5, 64, 64, device=cuda)
    b = K.dropout_keep_mask(6, 0.5, 64, 64, device=cuda)
    assert not torch.equal(a, b)


def test_synthesize_routes_through_the_kernels(cuda):
    from fcl_taco2_tpu_torch.models import Tacotron2SA
    from fcl_taco2_tpu_torch.ops import decoder_cuda as K

    model = Tacotron2SA(tiny_config(dunits=256), device=cuda)
    tokens = torch.tensor([[1, 4, 2, 7, 0]], device=cuda)
    ilens = torch.tensor([4], device=cuda)
    durs = torch.tensor([[2, 3, 1, 4, 0]], device=cuda)
    for backend, kernel in (("auto", K.fused_ar_decode),
                            ("pallas_hbm", K.fused_ar_decode_hbm)):
        n0 = kernel.launches
        out = model.synthesize(tokens, ilens, 0, 16, durations=durs,
                               decoder_backend=backend)
        assert kernel.launches == n0 + 1, backend
        mel = out["mel"].cpu().numpy()
        assert np.isfinite(mel).all() and int(out["olens"][0]) == 10
        assert (mel[0, 10:] == 0).all()
    # hybrid: P = 3 * 48 > TILE, head tile on the kernel, rest on the scan
    g = torch.Generator().manual_seed(0)
    tokens = torch.randint(1, 11, (3, 48), generator=g).to(cuda)
    durs = torch.randint(0, 7, (3, 48), generator=g).to(cuda)
    ilens = torch.full((3,), 48, device=cuda)
    n0 = K.fused_ar_decode_hbm.launches
    out = model.synthesize(tokens, ilens, 0, 512, durations=durs,
                           decoder_backend="hybrid")
    assert K.fused_ar_decode_hbm.launches == n0 + 1
    assert torch.equal(out["olens"], durs.sum(1).to(out["olens"].dtype))
    assert torch.isfinite(out["mel"]).all()


TOL_PWG = 1e-4  # fp32 sums in another order, over 6 residual layers


@pytest.fixture
def full_fp32(cuda):
    """Full fp32 products in the plain versions (no TF32), restored
    afterwards."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield cuda
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


def _pwg_inputs(dev, B, Tm, seed=0):
    from fcl_taco2_tpu_torch.vocoder.pwg import PWGConfig, ParallelWaveGAN
    cfg = PWGConfig(layers=6, stacks=2)  # PWG v1 widths, 6 layers
    pwg = ParallelWaveGAN(cfg, device=dev, seed=seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    mel = torch.randn(B, Tm, cfg.aux_channels, generator=g, device=dev)
    noise = torch.randn(B, Tm * cfg.hop, generator=g, device=dev)
    return cfg, pwg, mel, noise


def test_pwg_kernels_match_plain_versions(full_fp32):
    from fcl_taco2_tpu_torch.vocoder import pwg_cuda as PC
    from fcl_taco2_tpu_torch.vocoder.pwg import upsample_mel

    dev = full_fp32
    B, Tm = 2, 24
    cfg, pwg, mel, noise = _pwg_inputs(dev, B, Tm)
    W = Tm * cfg.hop
    n0 = PC.pwg_generate_streaming.launches
    oneshot = PC.pwg_generate_streaming(pwg, cfg, mel, noise)
    assert PC.pwg_generate_streaming.launches == n0 + 1
    want = PC.pwg_generate_streaming_plain(pwg, cfg, mel, noise)
    assert (oneshot - want).abs().max().item() < TOL_PWG

    packed = PC.pack_pwg_weights(pwg, cfg)
    delay = PC._round8(PC.total_delay(cfg))
    Vh = 1024
    n = -(-(W + delay) // Vh)
    aux = torch.zeros(B, n * Vh, cfg.aux_channels, device=dev)
    aux[:, :W] = upsample_mel(pwg, cfg, mel)
    nz = torch.zeros(B, n * Vh, device=dev)
    nz[:, :W] = noise
    st = PC.pwg_stream_state(cfg, B, device=dev)
    st_plain = PC.pwg_stream_state(cfg, B, device=dev)
    outs = []
    n1 = PC.pwg_stream_step.launches
    for j in range(n):
        sl = slice(j * Vh, (j + 1) * Vh)
        args = (aux[:, sl], nz[:, sl], j * Vh, W)
        wav, st = PC.pwg_stream_step(packed, cfg, st, *args)
        wp, st_plain = PC.pwg_stream_step_plain(packed, cfg, st_plain, *args)
        assert (wav - wp).abs().max().item() < TOL_PWG
        for a, b in zip([st["aux_hist"], st["acc"], *st["bufs"]],
                        [st_plain["aux_hist"], st_plain["acc"],
                         *st_plain["bufs"]]):
            assert a.shape == b.shape
            assert (a - b).abs().max().item() < TOL_PWG
        outs.append(wav)
    assert PC.pwg_stream_step.launches == n1 + n
    # every output element sums in one order whatever the tiling
    assert torch.equal(torch.cat(outs, dim=1)[:, delay:delay + W], oneshot)


def test_serving_paths_route_through_the_pwg_kernels(full_fp32):
    from fcl_taco2_tpu_torch.infer import StreamTTS, TTSPipeline
    from fcl_taco2_tpu_torch.models import Tacotron2SA
    from fcl_taco2_tpu_torch.vocoder import pwg_cuda as PC

    dev = full_fp32
    cfg, pwg, _, _ = _pwg_inputs(dev, 1, 1)
    model = Tacotron2SA(tiny_config(odim=cfg.aux_channels, dropout_rate=0.0),
                        device=dev)
    n0 = PC.pwg_generate_streaming.launches
    wavs, stats = TTSPipeline(model, pwg, device=dev).tts_batch(
        [np.array([1, 4, 2, 7]), np.array([3, 5])], 0)
    assert PC.pwg_generate_streaming.launches > n0
    assert sum(len(w) for w in wavs) == stats["frames"] * cfg.hop
    assert all(np.isfinite(w).all() for w in wavs)
    n1 = PC.pwg_stream_step.launches
    wav = StreamTTS(model, pwg, chunk_phonemes=2, device=dev).tts(
        np.array([1, 4, 2, 7]), 0, durations=[2, 3, 1, 4])
    assert PC.pwg_stream_step.launches > n1
    assert wav.shape == (10 * cfg.hop,) and np.isfinite(wav).all()
