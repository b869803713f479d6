"""The port's text -> mel slice against the JAX package's, on the CPU.

Same tiny configs, same weights (through the bridge), same numpy inputs;
dropout rates 0 so both sides are deterministic.  The full-model budget is
3e-4 (``tests/test_torch_parity.py:313``).  Predicted durations are
compared exactly before any mel is (round(exp(logd) - 1) could round
differently within fp noise of .5; the seeds here have no such value).

JAX on the CPU decodes with ``scan`` under ``auto``; the port's explicit
kernel backends run their plain versions here and are held against JAX's
scan: the resident entry (fp32 weights) at 3e-4, the streaming entry
(bf16 weights by design) at the JAX package's own 2e-3 for that
comparison (``tests/test_decoder_pallas.py:303-304``).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fcl_taco2_tpu.infer import Synthesizer as JSynth
from fcl_taco2_tpu.models import Tacotron2SA as JModel
from fcl_taco2_tpu_torch.infer import Synthesizer as PSynth

from helpers import tiny_config
from torch_port_helpers import port_model

ATOL = 3e-4
ATOL_BF16_STREAM = 2e-3
NODROP = dict(dropout_rate=0.0, duration_predictor_dropout_rate=0.0,
              pitch_predictor_dropout_rate=0.0,
              energy_predictor_dropout_rate=0.0,
              pitch_embed_dropout_rate=0.0, energy_embed_dropout_rate=0.0)
SHAPES = {
    # fits_l2 in fp32: the shape auto sends to the resident entry
    "student": dict(),
    # dunits % 256 == 0 and not L2-resident-small: the streaming shape
    "teacher": dict(dunits=256),
}


def _models(shape):
    cfg = tiny_config(**NODROP, **SHAPES[shape])
    jm = JModel(cfg)
    params, state = jm.init(jax.random.PRNGKey(0))
    # longer predicted durations than the near-zero default init gives
    params["duration_predictor"]["linear"]["b"] = \
        params["duration_predictor"]["linear"]["b"] + 1.2
    return jm, params, state, port_model(cfg, params, state)


@pytest.fixture(scope="module")
def models():
    return {s: _models(s) for s in SHAPES}


def _batch(B=2, Tmax=5, seed=0, max_dur=6):
    rng = np.random.default_rng(seed)
    ilens = np.array([Tmax] + list(rng.integers(2, Tmax + 1, B - 1)),
                     np.int32)
    tokens = np.zeros((B, Tmax), np.int32)
    durs = np.zeros((B, Tmax), np.int32)
    for b in range(B):
        tokens[b, :ilens[b]] = rng.integers(1, 11, ilens[b])
        durs[b, :ilens[b]] = rng.integers(0, max_dur + 1, ilens[b])
    return tokens, ilens, durs


def _run_both(models, shape, *, given, ragged, d_factor=1.0, backend="auto",
              B=2, Tmax=5, budget=40):
    jm, params, state, pm = models[shape]
    tokens, ilens, durs = _batch(B, Tmax)
    want = jm.synthesize(params, state, jnp.asarray(tokens),
                         jnp.asarray(ilens), jax.random.PRNGKey(1),
                         frame_budget=budget,
                         durations=jnp.asarray(durs) if given else None,
                         d_factor=d_factor, ragged_decode=ragged,
                         decoder_backend="scan")
    got = pm.synthesize(torch.from_numpy(tokens).long(),
                        torch.from_numpy(ilens).long(), 0, budget,
                        durations=torch.from_numpy(durs) if given else None,
                        d_factor=d_factor, ragged_decode=ragged,
                        decoder_backend=backend)
    np.testing.assert_array_equal(got["d_outs"].numpy(),
                                  np.asarray(want["d_outs"]))
    np.testing.assert_array_equal(got["olens"].numpy(),
                                  np.asarray(want["olens"]))
    assert int(np.asarray(want["olens"]).sum()) > 0
    return got["mel"].numpy(), np.asarray(want["mel"])


@pytest.mark.parametrize("shape,given,ragged,d_factor", [
    ("student", True, True, 1.0),
    ("student", False, False, 1.0),
    ("teacher", True, False, 1.5),
    ("teacher", False, True, 0.75),
])
def test_synthesize_matches_jax(models, shape, given, ragged, d_factor):
    got, want = _run_both(models, shape, given=given, ragged=ragged,
                          d_factor=d_factor)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_synthesize_with_speaker_embedding_matches_jax():
    """Multi-speaker conditioning: the L2-normalized speaker vector is
    concatenated to every token (taco2_sa.py:33-42)."""
    cfg = tiny_config(**NODROP, spk_embed_dim=3)
    jm = JModel(cfg)
    params, state = jm.init(jax.random.PRNGKey(2))
    pm = port_model(cfg, params, state)
    tokens, ilens, durs = _batch()
    spembs = np.random.default_rng(3).normal(size=(2, 3)).astype(np.float32)
    want = jm.synthesize(params, state, jnp.asarray(tokens),
                         jnp.asarray(ilens), jax.random.PRNGKey(1),
                         frame_budget=40, durations=jnp.asarray(durs),
                         spembs=jnp.asarray(spembs), decoder_backend="scan")
    got = pm.synthesize(torch.from_numpy(tokens).long(),
                        torch.from_numpy(ilens).long(), 0, 40,
                        durations=torch.from_numpy(durs),
                        spembs=torch.from_numpy(spembs))
    np.testing.assert_allclose(got["mel"].numpy(), np.asarray(want["mel"]),
                               atol=ATOL)


def test_resident_entry_matches_jax_scan(models):
    got, want = _run_both(models, "student", given=True, ragged=True,
                          backend="pallas")
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("backend,B,Tmax", [
    ("pallas_hbm", 2, 5),
    ("hybrid", 3, 48),  # P = 144 > TILE: head tile + residual scan
])
def test_streaming_entries_match_jax_scan(models, backend, B, Tmax):
    got, want = _run_both(models, "teacher", given=True, ragged=True,
                          backend=backend, B=B, Tmax=Tmax, budget=512)
    np.testing.assert_allclose(got, want, atol=ATOL_BF16_STREAM)


def test_backend_gates_raise_like_jax(models):
    _, _, _, pm = models["student"]
    tokens, ilens, _ = _batch()
    args = (torch.from_numpy(tokens).long(), torch.from_numpy(ilens).long(),
            0, 32)
    with pytest.raises(ValueError, match="pallas_hbm"):
        pm.synthesize(*args, decoder_backend="pallas_hbm")
    with pytest.raises(ValueError, match="quantize"):
        pm.synthesize(*args, quantize="int4")


def test_synthesizer_synth_batch_matches_jax(models):
    jm, params, state, pm = models["student"]
    toks = [np.array([1, 4, 2, 7], np.int32), np.array([3, 5], np.int32)]
    durs = [np.array([2, 3, 1, 4], np.int32), np.array([5, 2], np.int32)]
    kw = dict(batch_size=2, tok_bucket=8, frame_bucket=16)
    jmels, _ = JSynth(jm, params, state, **kw).synth_batch(
        toks, jax.random.PRNGKey(0), durations=durs)
    pmels, stats = PSynth(pm, device="cpu", **kw).synth_batch(
        toks, 0, durations=durs)
    assert stats["total_frames"] == 17
    for g, w in zip(pmels, jmels):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=ATOL)
    # predicted durations, with the exact re-dispatch on overrun
    jmels, jst = JSynth(jm, params, state, frame_per_token=1,
                        **kw).synth_batch(toks, jax.random.PRNGKey(0))
    pmels, pst = PSynth(pm, device="cpu", frame_per_token=1,
                        **kw).synth_batch(toks, 0)
    assert pst["redispatched"] == jst["redispatched"]
    for g, w in zip(pmels, jmels):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=ATOL)


# bf16 serving: XLA and PyTorch round bf16 in other places (fused biases,
# excess precision inside XLA's fusions), so the port's bf16 mel differs
# from JAX's by noise of the size of bf16's own distance from fp32.  The
# limit is twice JAX's own bf16-vs-fp32 gap on the same input (measured
# on this batch: port vs JAX ~0.01-0.02, JAX's gap ~0.01); the cast policy
# itself, which a misplaced cast would break without leaving that noise,
# is held op by op.
_SERVE_PRODUCTS = ("convolution", "mm", "addmm", "bmm")


@pytest.fixture
def one_thread():
    """One intra-op thread for tiny bf16 products: as fast, and the test
    workers sharing the cores do not oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_bf16_serving_policy_matches_jax(models, shape, one_thread):
    """``synthesize`` with ``compute_dtype="bfloat16"`` (the plain decode
    on the CPU) against JAX's (``taco2_sa.py``'s cast policy,
    ``tests/test_mixed_precision.py:40``): every convolution and matrix
    product, predicted and given durations alike, takes bf16 operands and
    gives bf16; the mel comes out fp32; values within the bf16 noise."""
    from torch.utils._python_dispatch import TorchDispatchMode

    jm, params, state, _ = models[shape]
    cfg16 = jm.cfg.replace(compute_dtype="bfloat16")
    jm16 = JModel(cfg16)
    pm = port_model(cfg16, params, state)
    tokens, ilens, durs = _batch()
    products = []

    class LogProducts(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if name in _SERVE_PRODUCTS:
                outs = out if isinstance(out, (tuple, list)) else (out,)
                products.append((name, {
                    t.dtype for t in (*args, *outs)
                    if isinstance(t, torch.Tensor) and t.is_floating_point()
                }))
            return out

    with LogProducts():
        for given in (False, True):
            got = pm.compute_model().synthesize(
                torch.from_numpy(tokens).long(),
                torch.from_numpy(ilens).long(), 0, 40,
                durations=torch.from_numpy(durs) if given else None)
    names = {n for n, _ in products}
    assert {"convolution", "mm"} <= names, names
    assert all(d == {torch.bfloat16} for _, d in products), \
        [p for p in products if p[1] != {torch.bfloat16}]
    assert got["mel"].dtype == torch.float32

    def jax_mel(model):
        return np.asarray(model.synthesize(
            params, state, jnp.asarray(tokens), jnp.asarray(ilens),
            jax.random.PRNGKey(1), frame_budget=40,
            durations=jnp.asarray(durs))["mel"])

    want16, want32 = jax_mel(jm16), jax_mel(jm)
    assert want16.dtype == np.float32
    jax_gap = float(np.abs(want16 - want32).max())
    err = float(np.abs(got["mel"].numpy() - want16).max())
    assert 0 < jax_gap and err <= 2 * jax_gap, (err, jax_gap)
