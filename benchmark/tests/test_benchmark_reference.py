"""The plain reference against the port on the CPU, at tiny widths: the
decoder loop against the kernels' plain versions (both loop types), the
whole text -> mel against ``Tacotron2SA.synthesize``, the vocoder
against ``pwg_generate``, and the Philox keying against a plain Python
Philox4x32-10."""

import numpy as np
import pytest
import torch

from benchmark import weights
from benchmark.reference import philox, pwg as ref_pwg, taco2 as ref_taco2
from benchmark.reference.precision import Precision, round_fp8, round_tf32
from benchmark.tests import tiny

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(dtype="float32", dropout=0.0, seed=5):
    from fcl_taco2_tpu_torch.models import ModelConfig, Tacotron2SA
    mc = dict(tiny.config()["model"], compute_dtype=dtype,
              dropout_rate=dropout)
    model = Tacotron2SA(ModelConfig(**mc), device="cpu")
    sd = weights.seeded_state(model, seed, "cpu", round_to=torch.bfloat16)
    model.load_state_dict(sd)
    return model, sd, mc


def _batch(seed=0, B=3, T=16):
    rng = np.random.default_rng(seed)
    ilens = np.array([T, T - 3, T - 7][:B])
    tokens = np.zeros((B, T), np.int64)
    durs = np.zeros((B, T), np.int32)
    for b, n in enumerate(ilens):
        tokens[b, :n] = rng.integers(1, 70, n)
        durs[b, :n] = np.clip(rng.poisson(4, n), 1, 10)
    return (torch.from_numpy(tokens), torch.from_numpy(ilens),
            torch.from_numpy(durs))


@pytest.mark.parametrize("loop_dtype", [torch.float32, torch.bfloat16])
def test_decoder_loop_matches_the_kernels_plain_versions(loop_dtype):
    from fcl_taco2_tpu_torch.ops.decoder_cuda import (
        fused_ar_decode_hbm_plain, fused_ar_decode_plain)
    model, sd, mc = _model()
    rng = np.random.default_rng(1)
    n, idim = 40, mc["eunits"]
    dur = torch.from_numpy(np.sort(rng.integers(1, 9, n))[::-1].copy())
    enc = torch.from_numpy(rng.normal(size=(n, idim)).astype(np.float32))
    got = ref_taco2.decode(sd, mc, enc, dur, 0, Precision(), loop_dtype,
                           torch.float32)
    S = got.shape[1]
    d = torch.arange(S)[None, :]
    pos = torch.where(d < dur[:, None], d.float() / dur[:, None].float(), 0.)
    plain = fused_ar_decode_plain if loop_dtype == torch.float32 \
        else fused_ar_decode_hbm_plain
    with torch.no_grad():
        want = plain(model.decoder.jax_layout(), enc, pos, 0, zoneout=0.1,
                     dropout=0.0, weights_dtype=loop_dtype)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-5)


def test_synthesize_matches_the_port():
    model, sd, mc = _model()
    tokens, ilens, durs = _batch()
    want = model.synthesize(tokens, ilens, 0, frame_budget=200,
                            durations=durs, decoder_backend="pallas")
    mel, olens = ref_taco2.synthesize(sd, mc, tokens, ilens, durs, 0,
                                      Precision(), torch.float32)
    assert olens.tolist() == want["olens"].tolist()
    for b in range(len(olens)):
        n = int(olens[b])
        np.testing.assert_allclose(mel[b, :n].numpy(),
                                   want["mel"][b, :n].numpy(), rtol=0,
                                   atol=2e-5)


def test_vocoder_matches_the_port():
    from fcl_taco2_tpu_torch.vocoder.pwg import (ParallelWaveGAN, PWGConfig,
                                                 pwg_generate)
    vc = tiny.config()["vocoder"]
    pwg = ParallelWaveGAN(PWGConfig(**dict(
        vc, upsample_scales=tuple(vc["upsample_scales"]))), device="cpu")
    sd = weights.seeded_state(pwg, 3, "cpu", round_to=torch.bfloat16)
    pwg.load_state_dict(sd)
    rng = np.random.default_rng(2)
    mel = torch.from_numpy(rng.normal(size=(2, 30, 80)).astype(np.float32))
    noise = torch.from_numpy(rng.normal(
        size=(2, 30 * ref_pwg.hop(vc))).astype(np.float32))
    got = ref_pwg.generate(sd, vc, mel, noise, Precision())
    want = pwg_generate(pwg, pwg.cfg, mel, noise)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


def _philox_py(seed, c0, c1, c2):
    m = 0xFFFFFFFF
    x = [c0, c1, c2, 0]
    k0, k1 = seed & m, 0x5BD1E995
    for _ in range(10):
        p0, p1 = 0xD2511F53 * x[0], 0xCD9E8D57 * x[2]
        x = [(p1 >> 32) ^ x[1] ^ k0, p1 & m, (p0 >> 32) ^ x[3] ^ k1, p0 & m]
        k0, k1 = (k0 + 0x9E3779B9) & m, (k1 + 0xBB67AE85) & m
    return x[0]


def test_philox_keying():
    rows = torch.tensor([0, 1, 7, 1000, 2 ** 20])
    bits = philox.philox_bits(123456789, rows[:, None], torch.tensor(3),
                              torch.tensor([0, 5, 300])[None, :])
    for i, r in enumerate(rows.tolist()):
        for j, c in enumerate([0, 5, 300]):
            assert int(bits[i, j]) == _philox_py(123456789, r, 3, c)
    keep = philox.prenet_keep(42, 0.5, torch.arange(512), 7, 1, 256)
    assert keep.shape == (512, 256)
    assert abs(keep.float().mean().item() - 0.5) < 0.01
    assert philox.prenet_keep(42, 0.0, torch.arange(4), 0, 0, 8).all()


def test_control_rounding():
    x = torch.tensor([1.0 + 2 ** -12, 3.14159265, -0.1], dtype=torch.float32)
    t = round_tf32(x)
    assert t[0].item() == 1.0 and abs(t[1].item() - 3.140625) < 1e-6
    assert (t.view(torch.int32) & 0x1FFF).eq(0).all()
    q = round_fp8(torch.linspace(-2, 2, 101))
    assert 0 < (q - torch.linspace(-2, 2, 101)).abs().max() < 0.07
    pr = Precision("control")
    assert pr.lo(x.bfloat16()).dtype == torch.bfloat16
    assert torch.equal(pr.lo(x), round_tf32(x))
