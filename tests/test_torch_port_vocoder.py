"""The port's Parallel WaveGAN against the JAX package's, on the CPU.

Same small configs (``tests/test_vocoder.py:13-16``,
``tests/test_stream.py:26-29``), same weights (through
``pwg_params_from_jax``), same numpy inputs.  The conv graph, the chunked
path and both plain kernel versions are held to JAX within 1e-5 (the
JAX package's own bound for its streaming kernel against the graph,
``tests/test_vocoder.py:127``); the plain versions to the Pallas kernels
run in interpret mode, state arrays included; chained plain stream steps
to the plain one-shot exactly (``tests/test_stream.py:65``).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fcl_taco2_tpu.vocoder import pwg as J
from fcl_taco2_tpu.vocoder import pwg_pallas as JP
from fcl_taco2_tpu_torch.utils.params import (pwg_params_from_jax,
                                              pwg_params_to_numpy)
from fcl_taco2_tpu_torch.vocoder import pwg as P
from fcl_taco2_tpu_torch.vocoder import pwg_cuda as PC

from torch_port_helpers import np_tree, port_pwg

ATOL = 1e-5
CFGS = {
    # tests/test_vocoder.py:13-16 (aux context window 1)
    "vocoder": dict(layers=6, stacks=2, residual_channels=8,
                    gate_channels=16, skip_channels=8, aux_channels=10,
                    upsample_scales=(2, 2), aux_context_window=1),
    # tests/test_stream.py:26-29
    "stream": dict(layers=6, stacks=2, residual_channels=8, gate_channels=16,
                   skip_channels=8, aux_channels=5, upsample_scales=(2, 2)),
}


def _setup(name, seed=0):
    jcfg = J.PWGConfig(**CFGS[name])
    params = J.pwg_init(jax.random.PRNGKey(seed), jcfg)
    model, cfg = port_pwg(jcfg, params)
    return jcfg, params, model, cfg


def _inputs(cfg, B, Tm, seed):
    rng = np.random.default_rng(seed)
    mel = rng.normal(size=(B, Tm, cfg.aux_channels)).astype(np.float32)
    noise = rng.normal(size=(B, Tm * cfg.hop)).astype(np.float32)
    return mel, noise


@pytest.mark.parametrize("name", sorted(CFGS))
def test_graph_and_chunked_match_jax(name):
    jcfg, params, model, cfg = _setup(name)
    mel, noise = _inputs(cfg, 2, 30, 0)
    jm, jn = jnp.asarray(mel), jnp.asarray(noise)
    tm, tn = torch.from_numpy(mel), torch.from_numpy(noise)
    np.testing.assert_allclose(P.upsample_mel(model, cfg, tm).numpy(),
                               np.asarray(J.upsample_mel(params, jcfg, jm)),
                               atol=ATOL)
    np.testing.assert_allclose(P.pwg_generate(model, cfg, tm, tn).numpy(),
                               np.asarray(J.pwg_generate(params, jcfg, jm,
                                                         jn)), atol=ATOL)
    got = P.pwg_generate_chunked(model, cfg, tm, tn, chunk_frames=8,
                                 context_frames=5).numpy()
    want = np.asarray(J.pwg_generate_chunked(params, jcfg, jm, jn,
                                             chunk_frames=8,
                                             context_frames=5))
    assert got.shape == want.shape == (2, 30 * cfg.hop)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_bridge_round_trip_is_exact():
    jcfg, params, model, cfg = _setup("vocoder")
    back = pwg_params_to_numpy(model.state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(np_tree(params))
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.shape == b.shape, path
        np.testing.assert_array_equal(a, b)


def _official_sd(cfg, rng):
    """A state dict with the official kan-bayashi key names and layouts
    (``tests/test_vocoder.py:48-77``)."""
    C, G, S, A = (cfg.residual_channels, cfg.gate_channels,
                  cfg.skip_channels, cfg.aux_channels)
    # scaled so that activations stay O(1), where 1e-5 is fp32 noise
    n = lambda *s: (0.3 * rng.normal(size=s)).astype(np.float32)  # noqa
    sd = {"first_conv.weight": n(C, 1, 1), "first_conv.bias": n(C),
          "upsample_net.conv_in.weight": n(A, A, 3),
          "last_conv_layers.1.weight": n(S, S, 1),
          "last_conv_layers.1.bias": n(S),
          "last_conv_layers.3.weight": n(1, S, 1),
          "last_conv_layers.3.bias": n(1),
          "some_extra.running_stat": n(2)}  # ignored, as JAX ignores it
    for i, s in enumerate(cfg.upsample_scales):
        sd[f"upsample_net.upsample.up_layers.{2 * i + 1}.weight"] = \
            n(1, 1, 1, 2 * s + 1)
    for i in range(cfg.layers):
        p = f"conv_layers.{i}"
        sd.update({f"{p}.conv.weight": n(G, C, 3), f"{p}.conv.bias": n(G),
                   f"{p}.conv1x1_aux.weight": n(G, A, 1),
                   f"{p}.conv1x1_out.weight": n(C, G // 2, 1),
                   f"{p}.conv1x1_out.bias": n(C),
                   f"{p}.conv1x1_skip.weight": n(S, G // 2, 1),
                   f"{p}.conv1x1_skip.bias": n(S)})
    return sd


def test_official_import_and_checkpoint_match_jax(tmp_path):
    jcfg, _, _, cfg = _setup("vocoder")
    sd = _official_sd(cfg, np.random.default_rng(0))
    mel, noise = _inputs(cfg, 1, 6, 1)
    want = np.asarray(J.pwg_generate(J.import_pwg_state_dict(sd, jcfg), jcfg,
                                     jnp.asarray(mel), jnp.asarray(noise)))
    model = P.import_pwg_state_dict(sd, cfg, device="cpu")
    # the same weights as the JAX import, exactly
    flat_j = jax.tree_util.tree_leaves(np_tree(J.import_pwg_state_dict(
        sd, jcfg)))
    flat_p = jax.tree_util.tree_leaves(pwg_params_to_numpy(
        model.state_dict()))
    for a, b in zip(flat_p, flat_j, strict=True):
        np.testing.assert_array_equal(a, b)
    got = P.pwg_generate(model, cfg, torch.from_numpy(mel),
                         torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    path = tmp_path / "pwg.pkl"
    torch.save({"model": {"generator": {k: torch.from_numpy(v)
                                        for k, v in sd.items()}}}, path)
    loaded = P.load_pwg_checkpoint(path, cfg, device="cpu")
    for k, v in loaded.state_dict().items():
        torch.testing.assert_close(v, model.state_dict()[k], rtol=0, atol=0)
    del sd["conv_layers.3.conv.bias"]
    with pytest.raises(KeyError, match="conv_layers.3.conv.bias"):
        P.import_pwg_state_dict(sd, cfg, device="cpu")


def test_plain_oneshot_matches_pallas_interpret_and_graph():
    """Both edges: the masks make the stream exact against the graph over
    the whole utterance, tail included."""
    jcfg, params, model, cfg = _setup("stream")
    mel, noise = _inputs(cfg, 2, 30, 0)
    jm, jn = jnp.asarray(mel), jnp.asarray(noise)
    want = np.asarray(JP.pwg_generate_streaming(params, jcfg, jm, jn,
                                                tile=16, interpret=True))
    got = PC.pwg_generate_streaming_plain(model, cfg, torch.from_numpy(mel),
                                          torch.from_numpy(noise),
                                          tile=16).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)
    graph = np.asarray(J.pwg_generate(params, jcfg, jm, jn))
    np.testing.assert_allclose(got, graph, atol=ATOL)
    with pytest.raises(ValueError, match="noise"):
        PC.pwg_generate_streaming_plain(model, cfg, torch.from_numpy(mel),
                                        torch.from_numpy(noise[:, :-1]))


def _state_np(st):
    return [st["aux_hist"], st["acc"], *st["bufs"]]


def test_plain_stream_steps_match_pallas_interpret_and_chain_exactly():
    jcfg, params, model, cfg = _setup("stream")
    B, Tm, Vh, T = 2, 20, 32, 16
    mel, noise = _inputs(cfg, B, Tm, 1)
    W = Tm * cfg.hop
    delay = PC._round8(PC.total_delay(cfg))
    assert delay == JP._round8(JP.total_delay(jcfg))
    n = -(-(W + delay) // Vh)
    aux = np.zeros((B, n * Vh, cfg.aux_channels), np.float32)
    aux[:, :W] = P.upsample_mel(model, cfg, torch.from_numpy(mel)).numpy()
    noise_p = np.zeros((B, n * Vh), np.float32)
    noise_p[:, :W] = noise

    jpacked = JP.pack_pwg_weights(params, jcfg)
    packed = PC.pack_pwg_weights(model, cfg)
    jst = JP.pwg_stream_state(jcfg, B)
    st = PC.pwg_stream_state(cfg, B, device="cpu")
    for a, b in zip(_state_np(st), _state_np(jst)):
        assert tuple(a.shape) == b.shape
    got = []
    for j in range(n):
        sl = slice(j * Vh, (j + 1) * Vh)
        jwav, jst = JP.pwg_stream_step(jpacked, jcfg, jst,
                                       jnp.asarray(aux[:, sl]),
                                       jnp.asarray(noise_p[:, sl]), j * Vh,
                                       W, tile=T, interpret=True)
        wav, st = PC.pwg_stream_step_plain(
            packed, cfg, st, torch.from_numpy(aux[:, sl]),
            torch.from_numpy(noise_p[:, sl]), j * Vh, W, tile=T)
        np.testing.assert_allclose(wav.numpy(), np.asarray(jwav), atol=ATOL)
        for a, b in zip(_state_np(st), _state_np(jst)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
        got.append(wav.numpy())
    got = np.concatenate(got, axis=1)[:, delay:delay + W]
    oneshot = PC.pwg_generate_streaming_plain(
        model, cfg, torch.from_numpy(mel), torch.from_numpy(noise),
        tile=T).numpy()
    np.testing.assert_array_equal(got, oneshot)
    with pytest.raises(ValueError, match="multiple of the tile"):
        PC.pwg_stream_step_plain(packed, cfg, st,
                                 torch.from_numpy(aux[:, :12]),
                                 torch.from_numpy(noise_p[:, :12]), 0, W,
                                 tile=T)


def test_vocode_dispatch_matches_jax_on_cpu():
    """``auto`` on CPU tensors is the chunked graph with the JAX
    package's context, as JAX's ``auto`` off the TPU; ``pallas`` runs the
    plain kernel version."""
    jcfg, params, model, cfg = _setup("stream")
    mel, noise = _inputs(cfg, 2, 40, 3)
    jm, jn = jnp.asarray(mel), jnp.asarray(noise)
    tm, tn = torch.from_numpy(mel), torch.from_numpy(noise)
    np.testing.assert_allclose(
        PC.vocode(model, cfg, tm, tn).numpy(),
        np.asarray(JP.vocode(params, jcfg, jm, jn, backend="auto")),
        atol=ATOL)
    torch.testing.assert_close(
        PC.vocode(model, cfg, tm, tn, backend="pallas"),
        PC.pwg_generate_streaming_plain(model, cfg, tm, tn), rtol=0, atol=0)
    with pytest.raises(ValueError, match="backend"):
        PC.vocode(model, cfg, tm, tn, backend="mosaic")


def test_prepacked_weights_give_the_same_wav():
    """Packing once (as ``TTSPipeline`` and ``StreamTTS`` do) changes
    nothing: the plain one-shot and ``vocode(backend="pallas")`` with
    ``packed=`` equal a fresh pack bit for bit."""
    _, _, model, cfg = _setup("stream")
    mel, noise = _inputs(cfg, 2, 20, 4)
    tm, tn = torch.from_numpy(mel), torch.from_numpy(noise)
    packed = PC.pack_pwg_weights(model, cfg)
    fresh = PC.pwg_generate_streaming(model, cfg, tm, tn, tile=16)
    for got in (PC.pwg_generate_streaming(model, cfg, tm, tn, tile=16,
                                          packed=packed),
                PC.vocode(model, cfg, tm, tn, backend="pallas", tile=16,
                          packed=packed)):
        torch.testing.assert_close(got, fresh, rtol=0, atol=0)
