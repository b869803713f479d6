"""The port's decoder-kernel wrappers (their plain versions, on the CPU)
against the JAX package's Pallas kernels in interpret mode and against its
``decoder_inference`` scan.

Tolerances are the JAX package's own (``tests/test_decoder_pallas.py``):
2e-5 in fp32 after the frame_mask multiply; ``0.05 * scale + 1e-3`` for
bf16 and int8 weights, whose rounding the AR feedback compounds.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import fcl_taco2_tpu.ops.decoder_pallas as dp
from fcl_taco2_tpu.models.config import student_config as j_student
from fcl_taco2_tpu.models.config import teacher_config as j_teacher
from fcl_taco2_tpu.models.decoder import decoder_inference, decoder_init
from fcl_taco2_tpu_torch.ops import decoder_cuda as K

from helpers import tiny_config
from torch_port_helpers import port_config, port_decoder, segment_inputs

ATOL_F32 = 2e-5

# (P, ragged): P=130 is not a multiple of TILE (two bound groups)
CASES = [(5, False), (5, True), (130, True)]


@pytest.fixture
def interpret(monkeypatch):
    """Pallas interpret mode, as tests/test_decoder_pallas.py:18-25."""
    import jax.experimental.pallas as pl
    orig = pl.pallas_call

    def interp_call(*a, **k):
        k.setdefault("interpret", True)
        return orig(*a, **k)

    monkeypatch.setattr(dp.pl, "pallas_call", interp_call)


def _setup(P, ragged, seed=0):
    cfg = tiny_config(dropout_rate=0.0, max_dur=7)
    params, state = decoder_init(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(seed)
    dur = rng.integers(0, cfg.max_dur + 1, P).astype(np.int32)
    if ragged:  # synthesize sorts segments by duration, descending
        dur = np.sort(dur)[::-1].copy()
    enc, fm, pos = segment_inputs(cfg.eunits, dur, cfg.max_dur, seed)
    dec = port_decoder(cfg, params, state)
    jb = dp.tile_step_bounds(jnp.asarray(dur)) if ragged else None
    tb = K.tile_step_bounds(torch.from_numpy(dur)) if ragged else None
    want_scan = np.asarray(decoder_inference(
        params, state, cfg, jnp.asarray(enc), jnp.asarray(dur),
        jnp.asarray(pos), jnp.asarray(fm), jax.random.PRNGKey(1)))
    return dict(cfg=cfg, params=params, dur=dur, enc=enc, fm=fm[..., None],
                pos=pos, dec_params=dec.jax_layout(), jb=jb, tb=tb,
                want_scan=want_scan)


def _budget_ok(got, want):
    err = np.abs(got - want).max()
    scale = np.abs(want).max()
    assert err < 0.05 * scale + 1e-3, (err, scale)


@pytest.mark.parametrize("P,ragged", CASES)
def test_fused_ar_decode_matches_pallas_and_scan(interpret, P, ragged):
    s = _setup(P, ragged)
    zo = s["cfg"].zoneout_rate
    with torch.no_grad():
        for jdt, tdt in ((jnp.float32, torch.float32),
                         (jnp.bfloat16, torch.bfloat16)):
            want = np.asarray(dp.fused_ar_decode(
                s["params"], jnp.asarray(s["enc"]), jnp.asarray(s["pos"]), 0,
                zoneout=zo, dropout=0.0, weights_dtype=jdt,
                bounds=s["jb"])) * s["fm"]
            got = K.fused_ar_decode(
                s["dec_params"], torch.from_numpy(s["enc"]),
                torch.from_numpy(s["pos"]), 0, zoneout=zo, dropout=0.0,
                weights_dtype=tdt, bounds=s["tb"]).numpy() * s["fm"]
            if tdt == torch.float32:
                np.testing.assert_allclose(got, want, atol=ATOL_F32)
                np.testing.assert_allclose(got, s["want_scan"],
                                           atol=ATOL_F32)
            else:
                _budget_ok(got, want)
                _budget_ok(got, s["want_scan"])


@pytest.mark.parametrize("wdt", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("P,ragged", CASES)
def test_fused_ar_decode_hbm_matches_pallas_and_scan(interpret, P, ragged,
                                                     wdt):
    s = _setup(P, ragged)
    zo = s["cfg"].zoneout_rate
    want = np.asarray(dp.fused_ar_decode_hbm(
        s["params"], jnp.asarray(s["enc"]), jnp.asarray(s["pos"]), 0,
        zoneout=zo, dropout=0.0, weights_dtype=getattr(jnp, wdt),
        bounds=s["jb"])) * s["fm"]
    with torch.no_grad():
        got = K.fused_ar_decode_hbm(
            s["dec_params"], torch.from_numpy(s["enc"]),
            torch.from_numpy(s["pos"]), 0, zoneout=zo, dropout=0.0,
            weights_dtype=getattr(torch, wdt),
            bounds=s["tb"]).numpy() * s["fm"]
    if wdt == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL_F32)
        np.testing.assert_allclose(got, s["want_scan"], atol=ATOL_F32)
    else:
        _budget_ok(got, want)
        _budget_ok(got, s["want_scan"])


def test_quantize_per_column_codes_equal_jax():
    """Codes and scales equal JAX's exactly, ties included (both round
    half to even), from fp32 and from bf16 weights."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(24, 40)).astype(np.float32)
    w[:, 7] = 0.0  # dead column: codes stay 0
    w[:4, 9] = [127.0, 63.5, -62.5, 0.5]  # scale 1: exact .5 ties
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        jq, js = dp.quantize_per_column(jnp.asarray(w).astype(jdt))
        tq, ts = K.quantize_per_column(torch.from_numpy(w).to(tdt))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq.dtype == torch.int8 and (tq[:, 7] == 0).all()


def test_prequantize_matches_jax_and_gates_on_config():
    cfg = tiny_config(dunits=256, compute_dtype="bfloat16")
    params, state = decoder_init(jax.random.PRNGKey(0), cfg)
    dec = port_decoder(cfg, params, state)
    jq, js = dp.prequantize_hbm_weights(params, compute_dtype=jnp.bfloat16)
    with torch.no_grad():
        tq, ts = K.maybe_prequantize(port_config(cfg), dec.jax_layout(),
                                     "int8")
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert K.maybe_prequantize(port_config(cfg), dec.jax_layout(),
                               "none") is None
    assert K.maybe_prequantize(port_config(tiny_config()), None,
                               "int8") is None  # dunits=20: not streamable


def test_tile_step_bounds_matches_jax():
    dur = np.random.default_rng(1).integers(0, 51, 300).astype(np.int32)
    np.testing.assert_array_equal(
        K.tile_step_bounds(torch.from_numpy(dur)).numpy(),
        np.asarray(dp.tile_step_bounds(jnp.asarray(dur))))


def test_entry_policy_sends_student_resident_and_teacher_streaming():
    """``auto``'s config split on the card: the student's decoder weights
    stay L2-resident in fp32 (resident entry), the teacher's do not in
    either dtype (streaming entry) — the same split the JAX package's
    VMEM policy makes for the two published models."""
    student = port_config(j_student(70, odim=80))
    teacher = port_config(j_teacher(70, odim=80))
    assert K.fits_l2(student, torch.float32)
    assert not K.fits_l2(teacher, torch.float32)
    assert not K.fits_l2(teacher, torch.bfloat16)
    assert K.hbm_stream_compatible(teacher)
    assert dp.fits_vmem(j_student(70, odim=80))
    assert not dp.fits_vmem(j_teacher(70, odim=80),
                            weights_dtype=jnp.bfloat16)
