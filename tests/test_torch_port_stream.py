"""The port's streaming TTS (``infer/stream.py``) against the JAX
package's, on the CPU (``tests/test_stream.py:68-195`` on the port).

Same tiny configs and weights (through the bridges), durations given,
dropout 0, the same numpy noise.  Joined chunks equal the port's one-shot
path (``synthesize`` + ``pwg_generate``) and the JAX ``StreamTTS`` (its
kernels in interpret mode) within 2e-5, the JAX package's own bound for
its stream (``tests/test_stream.py:113``), with fp32 and with int8
decode weights.  (The int8 decode rounds activations to bf16 before each
product, so a last-bit difference could flip one rounding; these inputs
flip none: the port is 3e-7 from JAX there.)
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import fcl_taco2_tpu.ops.decoder_pallas as dp
from fcl_taco2_tpu.infer.stream import StreamTTS as JStream
from fcl_taco2_tpu.models import Tacotron2SA as JModel
from fcl_taco2_tpu.vocoder import pwg as J
from fcl_taco2_tpu_torch.infer import StreamTTS
from fcl_taco2_tpu_torch.vocoder.pwg import pwg_generate

from helpers import tiny_config
from torch_port_helpers import port_model, port_pwg

ATOL = 2e-5
TOKENS = np.array([3, 1, 7, 2, 9, 4, 10], np.int32)
DUR = np.array([3, 0, 5, 2, 6, 1, 4], np.int32)
STREAM_KW = dict(chunk_phonemes=3, postnet_chunk=4, vocode_frames=4,
                 tile=8, budget_round=16)
VARIANTS = {
    "fp32": (dict(), dict()),
    "int8": (dict(dunits=256),
             dict(decoder_backend="pallas_hbm", quantize="int8")),
}


def _setup(variant):
    cfg_kw, kw = VARIANTS[variant]
    cfg = tiny_config(dropout_rate=0.0, zoneout_rate=0.0, **cfg_kw)
    jm = JModel(cfg)
    params, state = jm.init(jax.random.PRNGKey(0))
    jcfg = J.PWGConfig(layers=6, stacks=2, residual_channels=8,
                       gate_channels=16, skip_channels=8,
                       aux_channels=cfg.odim, upsample_scales=(2, 2))
    jpwg = J.pwg_init(jax.random.PRNGKey(3), jcfg)
    pm = port_model(cfg, params, state)
    pwg, _ = port_pwg(jcfg, jpwg)
    st = StreamTTS(pm, pwg, **STREAM_KW, **kw, device="cpu")
    return jm, params, state, jcfg, jpwg, pm, pwg, st, kw


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_stream_matches_oneshot_and_jax(variant, monkeypatch):
    jm, params, state, jcfg, jpwg, pm, pwg, st, kw = _setup(variant)
    T = TOKENS.shape[0]
    F = int(DUR.sum())
    Wtot = F * jcfg.hop
    noise = np.random.default_rng(7).normal(size=(Wtot,)).astype(np.float32)

    # the port's one-shot: whole-utterance synthesize + the conv graph
    tok_pad = np.zeros((1, 8), np.int64)
    tok_pad[0, :T] = TOKENS
    dur_pad = np.zeros((1, 8), np.int32)
    dur_pad[0, :T] = DUR
    out = pm.synthesize(torch.from_numpy(tok_pad), torch.tensor([T]), 5, 32,
                        durations=torch.from_numpy(dur_pad), **kw)
    assert int(out["olens"][0]) == F
    want = pwg_generate(pwg, pwg.cfg, out["mel"][:, :F],
                        torch.from_numpy(noise)[None])[0].numpy()

    chunks = list(st.stream(TOKENS, 5, durations=DUR, noise=noise))
    assert len(chunks) > 1  # actually streamed
    got = np.concatenate(chunks)
    assert got.shape == (Wtot,)
    np.testing.assert_allclose(got, want, atol=ATOL)

    # the JAX package's stream, its Pallas kernels in interpret mode
    orig = dp.pl.pallas_call

    def interp_call(*a, **k):
        k.setdefault("interpret", True)
        return orig(*a, **k)

    monkeypatch.setattr(dp.pl, "pallas_call", interp_call)
    jst = JStream(jm, params, state, jpwg, jcfg, interpret=True,
                  **STREAM_KW, **kw)
    jgot = np.concatenate(list(jst.stream(TOKENS, jax.random.PRNGKey(5),
                                          durations=DUR, noise=noise)))
    np.testing.assert_allclose(got, jgot, atol=ATOL)


def test_stream_rejects_short_noise():
    *_, st, _ = _setup("fp32")
    with pytest.raises(ValueError, match="noise"):
        list(st.stream(np.array([3, 1, 7]), 0, durations=[4, 4, 4],
                       noise=np.zeros(5, np.float32)))


def test_stream_predicted_durations_smoke():
    """Predicted durations, prenet dropout on: sum(d_outs) * hop finite
    samples (``tests/test_stream.py:166-182``)."""
    cfg = tiny_config(dropout_rate=0.5, zoneout_rate=0.0)
    jm = JModel(cfg)
    params, state = jm.init(jax.random.PRNGKey(0))
    jcfg = J.PWGConfig(layers=6, stacks=2, residual_channels=8,
                       gate_channels=16, skip_channels=8,
                       aux_channels=cfg.odim, upsample_scales=(2, 2))
    pwg, _ = port_pwg(jcfg, J.pwg_init(jax.random.PRNGKey(3), jcfg))
    pm = port_model(cfg, params, state)
    st = StreamTTS(pm, pwg, **STREAM_KW, device="cpu")
    tokens = np.array([3, 1, 7, 2, 9], np.int32)
    wav = st.tts(tokens, 2)
    padded = np.pad(tokens, (0, 3))[None]
    _, d_outs, _, _ = st.model.synth_frontend(
        torch.from_numpy(padded).long(), torch.tensor([5]))
    assert wav.shape[0] == int(d_outs[0, :5].sum()) * jcfg.hop
    assert np.isfinite(wav).all()
    jd = jm.synth_frontend(params, state, jnp.asarray(padded),
                           jnp.asarray([5]))[1]
    np.testing.assert_array_equal(d_outs.numpy(), np.asarray(jd))
