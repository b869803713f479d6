"""Compiled execution in the port (CUDA graphs wherever the JAX package
jits), checked on the CPU.

- Capture safety: every function the port captures on the card runs
  under a dispatch mode that raises on what a capture cannot hold: a read
  of a tensor's value on the host (``aten._local_scalar_dense``,
  ``aten.is_nonzero``) and shapes that depend on the data
  (``aten.nonzero``, ``aten.masked_select``, ``aten.index`` /
  ``aten.index_put`` with boolean indices).  The kernel entries are
  stubs that check their shapes and that the seed and the stream
  position are tensors (the plain versions read them on the host, as
  CPU oracles may).  The scan and ``hybrid`` routes run their loops to the
  static step count, so they read nothing on the host either.
  (On the CPU ``.tolist()`` and ``.numpy()`` bypass the dispatcher; on
  the card a capture refuses any read-back itself.)
- The fixed-shape scatter equals the boolean-mask scatter it replaced,
  on a batch whose frames overrun the budget.
- The plain kernels with the seed and the stream position given as
  device-style tensors equal the Pallas kernels in interpret mode
  (1e-5 / 2e-5, as ``test_torch_port_vocoder.py`` and
  ``test_torch_port_decoder.py``).
- KD with the teacher drawing from the step's generator: losses and
  gradients still match JAX at dropout 0 (1e-5, 1e-4); the teacher's
  draws are a function of the step generator's state; its zoneout keep
  rate passes a statistical test (ROADMAP §C).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fcl_taco2_tpu.ops.decoder_pallas as dp
from fcl_taco2_tpu.models.kd import KDStudent as JaxKD
from fcl_taco2_tpu.vocoder import pwg as J
from fcl_taco2_tpu.vocoder import pwg_pallas as JP
from fcl_taco2_tpu_torch.infer import stream as stream_mod
from fcl_taco2_tpu_torch.infer.pipeline import TTSPipeline
from fcl_taco2_tpu_torch.infer.stream import StreamTTS
from fcl_taco2_tpu_torch.models.kd import KDStudent, teacher_generator
from fcl_taco2_tpu_torch.models.taco2_sa import (Tacotron2SA,
                                                 scatter_to_timelines)
from fcl_taco2_tpu_torch.ops import decoder_cuda as K
from fcl_taco2_tpu_torch.train.optim import build_optimizer
from fcl_taco2_tpu_torch.train.state import TrainState
from fcl_taco2_tpu_torch.train.step import (EvalStep, TrainStep,
                                            make_kd_eval_step,
                                            make_kd_train_step,
                                            make_train_step)
from fcl_taco2_tpu_torch.utils.params import (params_to_numpy,
                                              pwg_params_to_numpy)
from fcl_taco2_tpu_torch.vocoder import pwg_cuda as PC

from helpers import synthetic_batch, tiny_config, with_duration_classes
from torch_port_helpers import (NO_DROPOUT, CaptureSafe, max_rel_err,
                                port_batch, port_config, port_grads_as_jax,
                                segment_inputs)

KEEP_SIGMAS = 4.0  # a keep rate's limit, in standard errors of its mean


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the test run's xdist workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# kernel stubs: the card's entries, checked and shaped, no host reads
# ---------------------------------------------------------------------------

def _check_seed(seed):
    assert torch.is_tensor(seed) and tuple(seed.shape) == (1,) \
        and seed.dtype == torch.int32, seed


def _decode_stub(calls):
    def stub(dec_params, enc_seg, position, seed, *, bounds=None,
             weights_dtype=None, prequant=None, zoneout=None, dropout=None,
             packed=None):
        _check_seed(seed)
        P, D = position.shape
        assert enc_seg.shape[0] == P and position.dtype == torch.float32
        assert bounds is not None and tuple(bounds.shape) == (-(-P // 128),)
        calls.append(P)
        odim = dec_params["feat_out"]["w"].shape[-1] \
            if "feat_out" in dec_params else position.shape[1]
        # a value made of the inputs, so the outputs depend on them
        return (enc_seg.float().sum(-1)[:, None, None]
                * position[..., None]).expand(P, D, odim) * 1e-3 \
            + seed.float() * 0
    return stub


@pytest.fixture
def stub_kernels(monkeypatch):
    calls = {"resident": [], "hbm": [], "pwg": [], "step": []}
    monkeypatch.setattr(K, "fused_ar_decode", _decode_stub(calls["resident"]))
    monkeypatch.setattr(K, "fused_ar_decode_hbm", _decode_stub(calls["hbm"]))

    def oneshot(params, cfg, mel, noise, tile=1024, packed=None):
        B, Tm, _ = mel.shape
        assert tuple(noise.shape) == (B, Tm * cfg.hop)
        calls["pwg"].append(B)
        return noise * 0 + mel.mean(-1).repeat_interleave(cfg.hop, dim=1)

    def step(packed, cfg, state, aux, noise, start, W=None, tile=1024):
        assert torch.is_tensor(start) and W is None
        assert tuple(start.shape) == (2,) and start.dtype == torch.int32
        assert aux.shape[:2] == noise.shape and aux.shape[1] % tile == 0
        calls["step"].append(aux.shape[1])
        new = {k: (tuple(b + 1 for b in v) if k == "bufs" else v + 1)
               for k, v in state.items()}
        return noise + aux.mean(-1) + start.float().sum(), new

    monkeypatch.setattr(PC, "pwg_generate_streaming", oneshot)
    monkeypatch.setattr(stream_mod, "pwg_stream_step", step)
    return calls


def _model(**kw):
    cfg = port_config(tiny_config(**kw))
    return Tacotron2SA(cfg, device="cpu", seed=0).compute_model()


def _serving_batch(cfg, B=2, Tmax=72, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, cfg.idim, (B, Tmax))
    ilens = np.array([Tmax] + [Tmax - 5] * (B - 1))
    tokens[1:, Tmax - 5:] = 0
    dur = rng.integers(0, cfg.max_dur + 1, (B, Tmax)).astype(np.int32)
    dur[1:, Tmax - 5:] = 0
    return (torch.from_numpy(tokens), torch.from_numpy(ilens),
            torch.from_numpy(dur))


ROUTES = {"pallas": dict(), "pallas_hbm": dict(dunits=256),
          "scan": dict(), "hybrid": dict(dunits=256)}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_synthesize_is_capture_safe(route, stub_kernels):
    """``synthesize`` at tiny widths (P = 144 > one 128-row tile) as the
    card's graph runs it: no route reads anything on the host (the scan
    and hybrid run to the static step count)."""
    m = _model(**ROUTES[route])
    tokens, ilens, dur = _serving_batch(m.cfg)
    gen = torch.Generator().manual_seed(0)
    assert m.decode_route(route) == route
    with CaptureSafe():
        out = m.synthesize(tokens, ilens, gen, 64, durations=dur,
                           d_factor=torch.tensor(1.0), decoder_backend=route)
    assert out["mel"].shape == (2, 64, m.cfg.odim)
    if route != "scan":
        assert stub_kernels["hbm" if route in ("pallas_hbm", "hybrid")
                            else "resident"]


def test_synth_vocode_is_capture_safe(stub_kernels, monkeypatch):
    """``TTSPipeline``'s graph body: the seed and noise draws and
    ``synth_vocode`` on the kernel route."""
    from fcl_taco2_tpu_torch.vocoder.pwg import ParallelWaveGAN, PWGConfig
    m = _model()
    pwg = ParallelWaveGAN(PWGConfig(layers=3, stacks=1, residual_channels=8,
                                    gate_channels=16, skip_channels=8,
                                    aux_channels=m.cfg.odim,
                                    upsample_scales=(2, 2)), device="cpu")
    pipe = TTSPipeline(m, pwg, device="cpu")
    monkeypatch.setattr(pipe.model, "synthesize", functools.partial(
        pipe.model.synthesize, decoder_backend="pallas"))
    monkeypatch.setattr("fcl_taco2_tpu_torch.infer.pipeline.vocode",
                        functools.partial(PC.vocode, backend="pallas"))
    tokens, ilens, dur = _serving_batch(m.cfg, Tmax=16)
    gen = torch.Generator().manual_seed(0)
    with CaptureSafe():
        wav, wav_lens, olens = pipe._graph_body((tokens, ilens, dur, 64), gen)
    assert wav.shape == (2, 64 * pipe.pwg_cfg.hop)
    assert stub_kernels["pwg"] == [2] and stub_kernels["resident"]


def test_stream_stages_are_capture_safe(stub_kernels):
    """The stream's four stages with their positions as tensors."""
    from fcl_taco2_tpu_torch.vocoder.pwg import ParallelWaveGAN, PWGConfig
    m = _model()
    pwg = ParallelWaveGAN(PWGConfig(layers=3, stacks=1, residual_channels=8,
                                    gate_channels=16, skip_channels=8,
                                    aux_channels=m.cfg.odim,
                                    upsample_scales=(2, 2)), device="cpu")
    st = StreamTTS(m, pwg, chunk_phonemes=3, postnet_chunk=4,
                   vocode_frames=4, tile=8, budget_round=16,
                   decoder_backend="pallas", device="cpu")
    gen = torch.Generator().manual_seed(0)
    cfg, D = st.cfg, st.cfg.max_dur
    tokens = torch.tensor([[3, 1, 7, 2, 9, 4, 10, 0]])
    dur = torch.tensor([[3, 0, 5, 2, 6, 1, 4, 0]], dtype=torch.int32)
    Lbuf = st.pad + 32 + st.tail
    mel_buf = torch.zeros(Lbuf + 1, cfg.odim)
    after_buf = torch.zeros(Lbuf, cfg.odim)
    vstate = PC.pwg_stream_state(st.pwg_cfg, 1, device="cpu")
    idx = torch.tensor([0, 1, 2])
    d_c = dur[0, :3]
    d_range = torch.arange(D)[None, :]
    mask = d_range < d_c[:, None]
    pos = torch.where(mask, d_range / d_c.clamp(min=1)[:, None], 0.0)
    with CaptureSafe():
        hs, d_outs = st._frontend((tokens, torch.tensor([7]), dur,
                                   torch.tensor(1.0)), gen)
        hs2, _ = st._frontend((tokens, torch.tensor([7]), None,
                               torch.tensor(1.0)), gen)
        mel_buf = st._decode_chunk((hs, idx, d_c, pos.float(), mask,
                                    torch.tensor([0, 3, 3],
                                                 dtype=torch.int32),
                                    mel_buf), gen)
        after_buf = st._postnet_chunk((mel_buf, after_buf, torch.tensor(0),
                                       torch.tensor(21)), gen)
        wav, vstate = st._vocode_step((vstate, after_buf, torch.tensor(1),
                                       torch.tensor(21), None), gen)
    assert wav.shape == (1, st.Vh) and stub_kernels["step"] == [st.Vh]
    assert hs.shape == hs2.shape and float(mel_buf[Lbuf].abs().sum()) == 0


def _tx_state(model, names_params=None):
    tx = build_optimizer(name="adam", lr=1e-3, grad_clip=1.0)
    names, params = zip(*model.named_parameters())
    return tx, TrainState(model, tx.init(params, names), 0, tx)


@pytest.mark.parametrize("classed", [True, False],
                         ids=["classed", "single_class"])
def test_train_and_eval_steps_are_capture_safe(classed):
    """The bodies ``TrainStep`` and ``EvalStep`` capture (forward,
    backward, the optimizer's device-side decisions, the BatchNorm
    write-back; the eval forward)."""
    cfg = tiny_config()
    m = Tacotron2SA(port_config(cfg), device="cpu", seed=0)
    batch = synthetic_batch(cfg, B=3, Tmax=5, seed=1)
    if classed:
        batch = with_duration_classes(batch, (3, cfg.max_dur))
    batch = port_batch(batch)
    tx, ts = _tx_state(m)
    step = make_train_step(tx)
    assert isinstance(step, TrainStep)
    step._ts = ts
    tx.counters_on(ts.opt_state, "cpu")
    before = [p.detach().clone() for p in m.parameters()]
    ev = EvalStep()
    ev._model = m
    with CaptureSafe():
        packed = step._graph_fn(batch, torch.Generator().manual_seed(0))
        rep = ev._graph_fn(batch, torch.Generator().manual_seed(1))
    assert torch.isfinite(packed).all() and torch.isfinite(rep).all()
    assert "loss" in step.report_keys and "loss" in ev.report_keys
    assert any(not torch.equal(a, b) for a, b in zip(before, m.parameters()))


@pytest.mark.parametrize("remat", [True, False], ids=["remat_on",
                                                      "remat_off"])
def test_kd_steps_are_capture_safe(remat):
    """The KD step's body (the teacher's forward on the step's generator,
    the student's step; checkpointed steps under remat) and the KD eval
    step."""
    tcfg = tiny_config(duration_classes=(3,), remat_decoder=remat)
    scfg = tiny_config(embed_dim=8, eunits=8, econv_chans=8, dunits=12,
                       prenet_units=6, postnet_chans=6,
                       duration_classes=(3,), remat_decoder=remat)
    kd = KDStudent(port_config(scfg), port_config(tcfg), device="cpu",
                   seed=0)
    batch = port_batch(with_duration_classes(
        synthetic_batch(tcfg, B=3, Tmax=5, seed=1), (3, tcfg.max_dur)))
    tx, ts = _tx_state(kd.student)
    step = make_kd_train_step(kd, tx)
    step._ts = ts
    tx.counters_on(ts.opt_state, "cpu")
    ev = make_kd_eval_step(kd)
    ev._model = kd.student
    with CaptureSafe():
        packed = step._graph_fn(batch, torch.Generator().manual_seed(0))
        rep = ev._graph_fn(batch, torch.Generator().manual_seed(1))
    assert torch.isfinite(packed).all() and torch.isfinite(rep).all()
    assert "decoder_loss" in step.report_keys


# ---------------------------------------------------------------------------
# the scatter
# ---------------------------------------------------------------------------

def test_fixed_shape_scatter_equals_the_boolean_mask_scatter():
    """Random segments whose frames overrun the budget: the spare-row
    scatter equals ``before[tgt] = seg_out[keep]`` exactly."""
    rng = np.random.default_rng(0)
    B, Tmax, D, odim, budget = 3, 9, 7, 5, 20
    P = B * Tmax
    dur = torch.from_numpy(rng.integers(0, D + 1, (B, Tmax))
                           .astype(np.int32))
    assert int(dur.sum(1).max()) > budget  # frames overrun the budget
    seg_utt = torch.arange(P) // Tmax
    seg_start = (torch.cumsum(dur, 1, dtype=torch.int32) - dur).reshape(P)
    order = torch.from_numpy(rng.permutation(P))
    flat = dur.reshape(P)[order]
    seg_utt, seg_start = seg_utt[order], seg_start[order]
    frame_mask = torch.arange(D)[None, :] < flat[:, None]
    seg_out = torch.from_numpy(rng.normal(size=(P, D, odim))
                               .astype(np.float32))
    got = scatter_to_timelines(seg_out, frame_mask, seg_utt, seg_start, B,
                               budget)
    frame_pos = seg_start[:, None] + torch.arange(D, dtype=torch.int32)
    keep = frame_mask & (frame_pos < budget)
    tgt = (seg_utt[:, None] * budget + frame_pos)[keep]
    want = seg_out.new_zeros(B * budget, odim)
    want[tgt] = seg_out[keep]
    assert torch.equal(got, want.view(B, budget, odim))


# ---------------------------------------------------------------------------
# the plain kernels with the device scalars
# ---------------------------------------------------------------------------

@pytest.fixture
def interpret(monkeypatch):
    """Pallas interpret mode, as tests/test_decoder_pallas.py:18-25."""
    import jax.experimental.pallas as pl
    orig = pl.pallas_call

    def interp_call(*a, **k):
        k.setdefault("interpret", True)
        return orig(*a, **k)

    monkeypatch.setattr(dp.pl, "pallas_call", interp_call)


@torch.no_grad()
def test_plain_decoders_take_the_seed_tensor(interpret):
    """Both plain entries with the seed as a (1,) int32 tensor against
    the Pallas kernels (seed 5) at dropout 0: 2e-5; and at dropout 0.5 the
    tensor seed draws what the int seed draws."""
    cfg = tiny_config(dropout_rate=0.0, max_dur=7)
    m = Tacotron2SA(port_config(cfg), device="cpu", seed=0)
    params = jax.tree_util.tree_map(
        jnp.asarray, params_to_numpy(m.state_dict())[0]["decoder"])
    dur = np.sort(np.random.default_rng(0).integers(0, 8, 9))[::-1].copy()
    enc, fm, pos = segment_inputs(cfg.eunits, dur.astype(np.int32), 7)
    dec_params = m.decoder.jax_layout()
    seed = torch.tensor([5], dtype=torch.int32)
    tb = K.tile_step_bounds(torch.from_numpy(dur))
    jb = dp.tile_step_bounds(jnp.asarray(dur))
    zo = cfg.zoneout_rate
    for jfn, fn in ((dp.fused_ar_decode, K.fused_ar_decode_plain),
                    (dp.fused_ar_decode_hbm, K.fused_ar_decode_hbm_plain)):
        kw = dict(zoneout=zo, dropout=0.0, weights_dtype=jnp.float32,
                  bounds=jb)
        want = np.asarray(jfn(params, jnp.asarray(enc), jnp.asarray(pos), 5,
                              **kw)) * fm[..., None]
        kw.update(weights_dtype=torch.float32, bounds=tb)
        got = fn(dec_params, torch.from_numpy(enc), torch.from_numpy(pos),
                 seed, **kw).numpy() * fm[..., None]
        np.testing.assert_allclose(got, want, atol=2e-5)
        kw["dropout"] = 0.5
        a = fn(dec_params, torch.from_numpy(enc), torch.from_numpy(pos),
               seed, **kw)
        b = fn(dec_params, torch.from_numpy(enc), torch.from_numpy(pos), 5,
               **kw)
        assert torch.equal(a, b)


def test_plain_stream_step_takes_the_position_tensor():
    """A plain stream step given (start, W) as one int32 tensor against
    the Pallas stream kernel in interpret mode (1e-5, wav and state), and
    equal to the step given ints."""
    jcfg = J.PWGConfig(layers=6, stacks=2, residual_channels=8,
                       gate_channels=16, skip_channels=8, aux_channels=5,
                       upsample_scales=(2, 2))
    from fcl_taco2_tpu_torch.vocoder.pwg import ParallelWaveGAN, PWGConfig
    cfg = PWGConfig(**{k: getattr(jcfg, k) for k in (
        "layers", "stacks", "residual_channels", "gate_channels",
        "skip_channels", "aux_channels", "upsample_scales")})
    model = ParallelWaveGAN(cfg, device="cpu", seed=0)
    params = jax.tree_util.tree_map(jnp.asarray,
                                    pwg_params_to_numpy(model.state_dict()))
    rng = np.random.default_rng(1)
    B, Tm, Vh, T = 1, 10, 64, 16
    W = Tm * cfg.hop
    delay = PC._round8(PC.total_delay(cfg))
    n = -(-(W + delay) // Vh)
    mel = rng.normal(size=(B, Tm, cfg.aux_channels)).astype(np.float32)
    aux = np.zeros((B, n * Vh, cfg.aux_channels), np.float32)
    from fcl_taco2_tpu_torch.vocoder import pwg as P
    aux[:, :W] = P.upsample_mel(model, cfg, torch.from_numpy(mel)).numpy()
    noise = np.zeros((B, n * Vh), np.float32)
    noise[:, :W] = rng.normal(size=(B, W))
    jpacked = JP.pack_pwg_weights(params, jcfg)
    packed = PC.pack_pwg_weights(model, cfg)
    jst = JP.pwg_stream_state(jcfg, B)
    st = st_int = PC.pwg_stream_state(cfg, B, device="cpu")
    for j in range(n):
        sl = slice(j * Vh, (j + 1) * Vh)
        a, z = torch.from_numpy(aux[:, sl]), torch.from_numpy(noise[:, sl])
        jwav, jst = JP.pwg_stream_step(jpacked, jcfg, jst,
                                       jnp.asarray(aux[:, sl]),
                                       jnp.asarray(noise[:, sl]), j * Vh, W,
                                       tile=T, interpret=True)
        wav, st = PC.pwg_stream_step_plain(
            packed, cfg, st, a, z, PC.stream_pos(j * Vh, W, "cpu"), tile=T)
        wav_int, st_int = PC.pwg_stream_step_plain(packed, cfg, st_int, a, z,
                                                   j * Vh, W, tile=T)
        np.testing.assert_allclose(wav.numpy(), np.asarray(jwav), atol=1e-5)
        for x, y in zip([st["aux_hist"], st["acc"], *st["bufs"]],
                        [jst["aux_hist"], jst["acc"], *jst["bufs"]]):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-5)
        assert torch.equal(wav, wav_int)


# ---------------------------------------------------------------------------
# KD: the teacher on the step's generator
# ---------------------------------------------------------------------------

def _kd(rates, **kw):
    tcfg = tiny_config(**rates, **kw)
    scfg = tiny_config(embed_dim=8, eunits=8, econv_chans=8, dunits=12,
                       prenet_units=6, postnet_chans=6, **rates, **kw)
    return tcfg, scfg, KDStudent(port_config(scfg), port_config(tcfg),
                                 device="cpu", seed=0)


def test_kd_still_matches_jax_at_dropout_0():
    """Losses 1e-5 and gradient leaves 1e-4 against JAX's KD loss on the
    same weights and batch (shared projections, single class)."""
    tcfg, scfg, kd = _kd(NO_DROPOUT)
    sp, ss = jax.tree_util.tree_map(
        jnp.asarray, params_to_numpy(kd.student.state_dict()))
    tp, tst = jax.tree_util.tree_map(
        jnp.asarray, params_to_numpy(kd.teacher.state_dict()))
    batch = synthetic_batch(tcfg, B=3, Tmax=5, seed=1)
    jkd = JaxKD(scfg, tcfg, share_proj=True)
    (jl, (jrep, _, _)), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jkd.loss_fn(p, ss, tp, tst, batch, jax.random.PRNGKey(2),
                              train=True), has_aux=True))(sp)
    loss, (rep, _, _) = kd.loss_fn(port_batch(batch),
                                   torch.Generator().manual_seed(0))
    loss.backward()
    for k in rep:
        np.testing.assert_allclose(float(rep[k]), float(jrep[k]), rtol=1e-5,
                                   err_msg=k)
    assert max_rel_err(jgrads, port_grads_as_jax(kd.student)) < 1e-4


def _teacher_masks(kd, batch, gen):
    kd.teacher.decoder.mask_taps = t_taps = []
    kd.student.decoder.mask_taps = s_taps = []
    try:
        kd.loss_fn(batch, gen)
    finally:
        kd.teacher.decoder.mask_taps = kd.student.decoder.mask_taps = None
    return t_taps, s_taps


def test_teacher_draws_follow_the_step_generator():
    """The teacher's zoneout masks: equal for equal step-generator states,
    different for different ones, different from the student's; keep
    share at the zoneout rate within KEEP_SIGMAS standard errors."""
    rates = dict(NO_DROPOUT, zoneout_rate=0.1)
    tcfg, _, kd = _kd(rates)
    assert teacher_generator(torch.Generator()) is not None
    batch = port_batch(synthetic_batch(tcfg, B=3, Tmax=5, seed=1))
    state = torch.Generator().manual_seed(11).get_state()
    runs = []
    for s in (state, state, torch.Generator().manual_seed(12).get_state()):
        g = torch.Generator()
        g.set_state(s)
        runs.append(_teacher_masks(kd, batch, g))
    (t0, s0), (t1, _), (t2, _) = runs
    assert t0 and all(torch.equal(a, b) for a, b in zip(t0, t1))
    assert not all(torch.equal(a, b) for a, b in zip(t0, t2))
    # the student's masks come from later draws of the same stream
    flat_t = torch.cat([t.flatten() for t in t0]).float()
    flat_s = torch.cat([t.flatten() for t in s0]).float()
    n = min(flat_t.numel(), flat_s.numel())
    assert not torch.equal(flat_t[:n], flat_s[:n])
    keeps = []
    for seed in range(20):
        t, _ = _teacher_masks(kd, batch, torch.Generator().manual_seed(seed))
        keeps.append(torch.cat([x.flatten() for x in t]).float())
    keep = torch.cat(keeps)
    rate = tcfg.zoneout_rate
    z = abs(float(keep.mean()) - rate) / (rate * (1 - rate)
                                          / keep.numel()) ** 0.5
    assert z < KEEP_SIGMAS, (float(keep.mean()), keep.numel(), z)
