"""Compiled execution on the paths the port ran eagerly before: multi-rank
steps and sharded serving over NCCL, the scan and ``hybrid`` decoder
routes, ``fcl_vocode``, ``vocode_chunked`` and the preprocessing frontend,
checked on the CPU (no card and no NCCL here; ``chip_smoke.py`` holds each
graph to its eager call bit for bit on the card).

- A rank's share carries the global batch's counts as one float32 vector:
  two shares of one shape whose frame counts differ give one graph key,
  and the losses read the counts as values.
- ``Mesh.stats`` under a simulated capture: the all-reduce's calls and
  bytes are recorded and added once a replay, as kernel launches are;
  ``timing`` is refused inside a capture.
- Over gloo a multi-rank step stays eager and says why, naming gloo; over
  NCCL it is graphed and says nothing.  Ranks whose graph keys differ
  raise before a capture instead of waiting in a collective.
- The scan route equals JAX's ``decoder_inference`` at dropout 0 with no
  bound, the batch's bound and a bound that cuts the durations (2e-5, as
  ``tests/test_torch_port_decoder.py``); the generator's state after a
  decode does not depend on the bound; the all-steps prenet draws keep at
  1 - rate (``tests/test_decoder_pallas.py:86``'s statistical check).
- The new graph bodies read nothing on the host: the frontend's bucket,
  ``fcl_vocode``'s bucket and ``vocode_chunked``'s chunk.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from fcl_taco2_tpu.models.decoder import decoder_inference as jax_inference
from fcl_taco2_tpu.models.decoder import decoder_init
from fcl_taco2_tpu_torch.data.loader import BatchUploader
from fcl_taco2_tpu_torch.models.decoder import (_prenet_draws,
                                                decoder_inference)
from fcl_taco2_tpu_torch.models.taco2_sa import Tacotron2SA
from fcl_taco2_tpu_torch.ops.masking import N_UTTS, OLENS, count_frames
from fcl_taco2_tpu_torch.parallel import _mp_worker as worker
from fcl_taco2_tpu_torch.parallel import distributed as D
from fcl_taco2_tpu_torch.parallel.mesh import Mesh, capture_plan
from fcl_taco2_tpu_torch.train.step import EvalStep, TrainStep
from fcl_taco2_tpu_torch.utils import graphs

from helpers import tiny_config
from torch_port_helpers import (CaptureSafe, port_config, port_decoder,
                                segment_inputs)

ATOL_F32 = 2e-5       # tests/test_torch_port_decoder.py, the JAX limit
KEEP_SIGMAS = 4.0     # a keep rate's limit, in standard errors of its mean


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the test run's xdist workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the global counts as a tensor
# ---------------------------------------------------------------------------

def test_shares_of_one_shape_share_one_graph_key():
    """A share's counts are a tensor: only their shape is in a graph's
    key, so shares whose frame counts differ share one graph, and the
    losses still read their values."""
    cfg = worker._tiny_cfg(use_batch_norm=False)
    g = worker._tiny_batch(cfg)
    other = g._replace(olens=g.olens - 1)  # same shapes, fewer frames
    shares = [BatchUploader("cpu")(D.batch_share(b, 0, 2))
              for b in (g, other)]
    keyer = graphs.Graphed(lambda x, _: x, "cpu", "keys")
    keys = [keyer._key(None, s)[0] for s in shares]
    assert keys[0] == keys[1]
    assert graphs.key_digest(keys[0]) == graphs.key_digest(keys[1])
    a, b = (s.counts for s in shares)
    assert a.dtype == torch.float32 and a[N_UTTS] == 8
    assert torch.equal(a[OLENS:], torch.from_numpy(g.olens).float())
    assert float(count_frames(a) - count_frames(b)) == 8.0
    model = Tacotron2SA(cfg, device="cpu", seed=0)
    with torch.no_grad():
        losses = [float(model.loss_fn(s, torch.Generator())[0])
                  for s in shares]
    assert losses[0] != losses[1]


def test_key_digest_follows_shapes_not_the_callers_key():
    keyer = graphs.Graphed(lambda x, _: x, "cpu", "keys")
    x = (torch.zeros(2, 3), 4)
    k1 = keyer._key(id(object()), x)[0]
    k2 = keyer._key("another process's id", x)[0]
    k3 = keyer._key(None, (torch.zeros(2, 4), 4))[0]
    assert graphs.key_digest(k1) == graphs.key_digest(k2)
    assert graphs.key_digest(k1) != graphs.key_digest(k3)


# ---------------------------------------------------------------------------
# Mesh.stats, the eager reason and the key check
# ---------------------------------------------------------------------------

@pytest.fixture
def fake_group(monkeypatch):
    """A mesh of two ranks whose collectives are no-ops in this process."""
    monkeypatch.setattr(dist, "all_reduce", lambda t, group=None: t)
    return Mesh((2,), ("data",), rank=0, groups=("group",))


def _simulated_capture(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)


def test_mesh_stats_count_once_per_replay(fake_group, monkeypatch):
    mesh = fake_group
    mesh.all_reduce_(torch.zeros(5))  # eager: counted now
    assert mesh.stats["calls"] == 1 and mesh.stats["bytes"] == 20
    # a simulated capture records the all-reduce and counts nothing
    monkeypatch.setattr(graphs, "_recording", {})
    monkeypatch.setattr(graphs, "_tallies", [])
    _simulated_capture(monkeypatch)
    mesh.all_reduce_list_([torch.zeros(3),
                           torch.zeros(2, dtype=torch.int32)])
    mesh.all_reduce_(torch.zeros(4, dtype=torch.float64))
    assert mesh.stats["calls"] == 1 and mesh.stats["bytes"] == 20
    entry = graphs._Entry(None, [], None, graphs._recording,
                          graphs._tallies, 0.0, 0, None)
    for _ in range(3):
        entry.count_replay(0, False)
    assert entry.replays == 3
    assert mesh.stats["calls"] == 1 + 3 * 2
    assert mesh.stats["bytes"] == 20 + 3 * (5 * 4 + 4 * 8)
    # the seconds would synchronize the card: refused inside a capture
    mesh.timing = True
    with pytest.raises(RuntimeError, match="CUDA events around its replay"):
        mesh.all_reduce_(torch.zeros(1))


def test_a_tally_outside_graphed_raises(fake_group, monkeypatch):
    _simulated_capture(monkeypatch)
    with pytest.raises(RuntimeError, match="outside utils/graphs.py"):
        fake_group.all_reduce_(torch.zeros(1))


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_only_gloo_keeps_multi_rank_steps_eager(backend, fake_group,
                                                monkeypatch, capsys):
    monkeypatch.setattr(dist, "get_backend", lambda group=None: backend)
    monkeypatch.setattr(graphs, "_said", set())
    graphed, mesh = capture_plan(fake_group, "train step")
    steps = [TrainStep(None, mesh=fake_group), EvalStep(mesh=fake_group)]
    said = capsys.readouterr().out
    if backend == "nccl":
        assert graphed and mesh is fake_group
        assert fake_group.captures_collectives
        assert all(s.graphed for s in steps) and said == ""
    else:
        assert not graphed and mesh is None
        assert not any(s.graphed for s in steps)
        assert "gloo" in said and "nccl" not in said.lower()
        assert said.count("\n") == 2  # train step, eval step: once each
    # one process: graphed, no mesh to capture over, nothing said
    assert capture_plan(None, "x") == (True, None)
    assert capture_plan(Mesh((1,), ("data",)), "x") == (True, None)


def test_ranks_with_other_graph_keys_raise(fake_group, monkeypatch):
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "gloo")
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    seen = {}

    def all_gather(out, t, group=None):
        for i, o in enumerate(out):
            o.copy_(t + seen["skew"] * i)

    monkeypatch.setattr(dist, "all_gather", all_gather)
    seen["skew"] = 0
    fake_group.check_same(12345, "train_step's key")
    seen["skew"] = 1
    with pytest.raises(RuntimeError, match="different CUDA graphs"):
        fake_group.check_same(12345, "train_step's key")


# ---------------------------------------------------------------------------
# the scan route to the static step count
# ---------------------------------------------------------------------------

def _scan_setup(dropout_rate=0.0, P=9, seed=0):
    cfg = tiny_config(dropout_rate=dropout_rate, max_dur=7)
    params, state = decoder_init(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(seed)
    dur = np.sort(rng.integers(0, 6, P))[::-1].astype(np.int32)
    enc, fm, pos = segment_inputs(cfg.eunits, dur, cfg.max_dur, seed)
    return cfg, params, state, dur, enc, fm, pos


@pytest.mark.parametrize("bound", [None, "max", 3])
def test_scan_matches_jax_with_and_without_a_bound(bound):
    """No bound, the batch's bound (5 of max_dur 7) and a bound of 3 that
    cuts the durations: JAX's traced ``fori_loop`` bound leaves the later
    steps zero, and so does the port's mask."""
    cfg, params, state, dur, enc, fm, pos = _scan_setup()
    b = None if bound is None else int(dur.max()) if bound == "max" \
        else bound
    want = np.asarray(jax_inference(
        params, state, cfg, jnp.asarray(enc), jnp.asarray(dur),
        jnp.asarray(pos), jnp.asarray(fm), jax.random.PRNGKey(1),
        step_bound=None if b is None else jnp.asarray(b)))
    dec = port_decoder(cfg, params, state)
    with CaptureSafe(), torch.no_grad():
        got = decoder_inference(
            dec, port_config(cfg), torch.from_numpy(enc),
            torch.from_numpy(dur), torch.from_numpy(pos),
            torch.from_numpy(fm), torch.Generator().manual_seed(1),
            step_bound=None if b is None else torch.tensor(b))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL_F32)
    if bound == 3:
        assert not got[:, 3:].any() and got[:, :3].abs().sum() > 0


def test_scan_draws_do_not_depend_on_the_bound():
    """The prenet's masks for all S steps are drawn whatever the bound:
    the generator ends in one state, and the steps both bounds run are
    equal."""
    cfg, params, state, dur, enc, fm, pos = _scan_setup(dropout_rate=0.5)
    dec = port_decoder(cfg, params, state)
    outs, states = [], []
    for b in (2, 5):
        gen = torch.Generator().manual_seed(3)
        with torch.no_grad():
            outs.append(decoder_inference(
                dec, port_config(cfg), torch.from_numpy(enc),
                torch.from_numpy(dur), torch.from_numpy(pos),
                torch.from_numpy(fm), gen, step_bound=torch.tensor(b)))
        states.append(gen.get_state())
    assert torch.equal(states[0], states[1])
    assert torch.equal(outs[0][:, :2], outs[1][:, :2])
    assert not outs[0][:, 2:].any() and outs[1][:, 2:5].abs().sum() > 0


def test_all_steps_prenet_draws_keep_at_one_minus_rate():
    jcfg = tiny_config(dropout_rate=0.5, max_dur=7)
    cfg = port_config(jcfg)
    dec = port_decoder(jcfg, *decoder_init(jax.random.PRNGKey(0), jcfg))
    S, P, rate = 7, 512, cfg.dropout_rate
    draws = _prenet_draws(dec, cfg, S, P, "cpu",
                          torch.Generator().manual_seed(0))
    assert len(draws) == cfg.prenet_layers
    for d in draws:
        keep = d < 1.0 - rate
        n = keep.numel()
        sigma = (rate * (1 - rate) / n) ** 0.5
        assert abs(float(keep.float().mean()) - (1 - rate)) \
            < KEEP_SIGMAS * sigma
        # every step draws masks of its own
        differ = float((keep[0] != keep[1]).float().mean())
        m = keep[0].numel()
        assert abs(differ - 2 * rate * (1 - rate)) \
            < KEEP_SIGMAS * (0.25 / m) ** 0.5


# ---------------------------------------------------------------------------
# the new graph bodies read nothing on the host
# ---------------------------------------------------------------------------

def test_frontend_bucket_is_capture_safe():
    from fcl_taco2_tpu_torch.audio.preprocess import Frontend, \
        PreprocessConfig
    cfg = PreprocessConfig(batch_frames=2 ** 15)
    fe = Frontend(cfg, "cpu")
    rng = np.random.default_rng(0)
    wavs = [rng.normal(size=n).astype(np.float32) * 0.1
            for n in (5000, 7000)]
    want = fe.process(wavs)
    [(chunk, L)] = list(fe._buckets(wavs))
    R, pad = len(chunk), cfg.n_fft // 2
    rows = np.zeros(R * (L + 2 * pad) + R * L, np.float32)
    stft = rows[:R * (L + 2 * pad)].reshape(R, -1)
    raw = rows[R * (L + 2 * pad):].reshape(R, L)
    for r, w in enumerate(wavs[j] for j in chunk):
        stft[r, :len(w) + 2 * pad] = np.pad(w, pad, mode="reflect")
        raw[r, :len(w)] = w
    with CaptureSafe():
        packed = fe._bucket((torch.from_numpy(rows), R, L), None)
    T, M = 1 + L // cfg.n_shift, cfg.n_mels
    for r, j in enumerate(chunk):
        mel, f0, _ = want[j]
        n = len(f0)
        np.testing.assert_array_equal(
            packed[r, :T * M].reshape(T, M)[:n].numpy(), mel)
        np.testing.assert_array_equal(packed[r, T * M:T * M + n].numpy(), f0)


def test_vocode_graph_bodies_are_capture_safe(monkeypatch):
    from fcl_taco2_tpu_torch.cli.fcl_vocode import (BucketVocoder,
                                                    vocode_utterance)
    from fcl_taco2_tpu_torch.infer.pipeline import vocode_chunked
    from fcl_taco2_tpu_torch.vocoder.pwg import ParallelWaveGAN, PWGConfig
    cfg = PWGConfig(layers=3, stacks=1, residual_channels=8,
                    gate_channels=16, skip_channels=8, aux_channels=8,
                    upsample_scales=(2, 2))
    pwg = ParallelWaveGAN(cfg, device="cpu", seed=0)
    mel = np.random.default_rng(0).normal(size=(70, 8)).astype(np.float32)
    voc = BucketVocoder(pwg, cfg, backend="xla")
    gen = torch.Generator().manual_seed(4)
    with CaptureSafe():
        wav = voc(mel, gen)
    # the eager CLI's draw: Tb * hop samples of noise, then the vocode
    noise = torch.randn(128 * cfg.hop,
                        generator=torch.Generator().manual_seed(4))
    np.testing.assert_array_equal(
        wav, vocode_utterance(pwg, cfg, mel, noise, backend="xla"))
    with CaptureSafe():
        chunks = list(vocode_chunked(pwg, cfg, mel, noise[:70 * cfg.hop],
                                     chunk_frames=16))
    assert sum(len(c) for c in chunks) == 70 * cfg.hop
