"""The port's text -> wav slice (``infer/pipeline.py``) against the JAX
package's, on the CPU.

Same tiny configs (``tests/test_pipeline.py:15-18``), same weights through
the bridges, same numpy noise; dropout 0.  The JAX side is
``synthesize`` + ``vocode`` with the pipeline's roundings (PWG weights,
mel and noise to ``pwg_dtype``, upcast to fp32 as the kernel does,
``pipeline.py:69-79``); on CPU tensors both ``vocode``s take the chunked
graph.  Budget 3e-4, as for ``synthesize`` (``test_torch_port_synth.py``).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fcl_taco2_tpu.infer.pipeline import (pwg_receptive_field as
                                          j_receptive_field)
from fcl_taco2_tpu.models import Tacotron2SA as JModel
from fcl_taco2_tpu.vocoder import pwg as J
from fcl_taco2_tpu.vocoder.pwg_pallas import vocode as j_vocode
from fcl_taco2_tpu_torch.infer import (TTSPipeline, pwg_receptive_field,
                                       vocode_chunked)
from fcl_taco2_tpu_torch.vocoder.pwg import PWGConfig, pwg_generate

from helpers import tiny_config
from test_torch_port_synth import NODROP
from torch_port_helpers import port_model, port_pwg

ATOL = 3e-4
PWG = dict(layers=4, stacks=2, residual_channels=8, gate_channels=16,
           skip_channels=8, aux_channels=8, upsample_scales=(2, 2),
           aux_context_window=1)


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_config(**NODROP)  # odim 8 == the PWG's aux channels
    jm = JModel(cfg)
    params, state = jm.init(jax.random.PRNGKey(0))
    jcfg = J.PWGConfig(**PWG)
    jpwg = J.pwg_init(jax.random.PRNGKey(1), jcfg)
    pwg, _ = port_pwg(jcfg, jpwg)
    return jm, params, state, jcfg, jpwg, port_model(cfg, params, state), pwg


@pytest.mark.parametrize("pwg_dtype", ["bfloat16", "float32"])
def test_synth_vocode_matches_jax(setup, pwg_dtype):
    jm, params, state, jcfg, jpwg, pm, pwg = setup
    rng = np.random.default_rng(0)
    tokens = np.array([[3, 1, 7, 2, 9], [4, 5, 2, 0, 0]], np.int32)
    ilens = np.array([5, 3], np.int32)
    budget = 64
    noise = rng.normal(size=(2, budget * jcfg.hop)).astype(np.float32)

    out = jm.synthesize(params, state, jnp.asarray(tokens),
                        jnp.asarray(ilens), jax.random.PRNGKey(1),
                        frame_budget=budget)
    dt = jnp.dtype(pwg_dtype)
    rnd = lambda x: x.astype(dt).astype(jnp.float32)  # noqa: E731
    want = np.asarray(j_vocode(jax.tree_util.tree_map(rnd, jpwg), jcfg,
                               rnd(out["mel"]), rnd(jnp.asarray(noise))))

    pipe = TTSPipeline(pm, pwg, pwg_dtype=pwg_dtype, device="cpu")
    wav, wav_lens, olens = pipe.synth_vocode(
        torch.from_numpy(tokens).long(), torch.from_numpy(ilens).long(), 0,
        budget, torch.from_numpy(noise))
    np.testing.assert_array_equal(olens.numpy(), np.asarray(out["olens"]))
    np.testing.assert_array_equal(wav_lens.numpy(),
                                  np.asarray(out["olens"]) * jcfg.hop)
    assert int(olens.min()) > 0
    assert wav.shape == want.shape == (2, budget * jcfg.hop)
    np.testing.assert_allclose(wav.numpy(), want, atol=ATOL)


def test_tts_batch_returns_trimmed_wavs(setup):
    *_, pm, pwg = setup
    pipe = TTSPipeline(pm, pwg, device="cpu")
    toks = [np.array([1, 2, 3], np.int32), np.array([4, 5], np.int32)]
    wavs, stats = pipe.tts_batch(toks, 2)
    assert len(wavs) == 2 and stats["rtf_x"] > 0
    assert sum(len(w) for w in wavs) == stats["frames"] * pwg.cfg.hop
    for w in wavs:
        assert w.ndim == 1 and np.isfinite(w).all()
    again, _ = pipe.tts_batch(toks, 2)  # same seed, same audio
    for a, b in zip(wavs, again):
        np.testing.assert_array_equal(a, b)


def test_chunked_vocoding_matches_full(setup):
    """``tests/test_pipeline.py:39-53`` on the port."""
    *_, pwg = setup
    cfg = pwg.cfg
    rng = np.random.default_rng(0)
    T = 40
    mel = rng.normal(size=(T, cfg.aux_channels)).astype(np.float32)
    noise = rng.normal(size=(T * cfg.hop,)).astype(np.float32)
    full = pwg_generate(pwg, cfg, torch.from_numpy(mel)[None],
                        torch.from_numpy(noise)[None])[0].numpy()
    stitched = np.concatenate(list(vocode_chunked(pwg, cfg, mel, noise,
                                                  chunk_frames=8)))
    assert stitched.shape == full.shape
    np.testing.assert_allclose(stitched, full, atol=1e-4)
    assert pwg_receptive_field(PWGConfig()) == j_receptive_field(
        J.PWGConfig())
