"""The device-resident dataset cache and the chained train step of the
port (``data/device_cache.py``, ``train/step.py::make_chained_train_step``)
against the JAX package and the port's streaming path, on the CPU:

- ``assemble`` bit-equal to the port's ``BatchConverter`` and to JAX's
  ``DeviceBatchCache.assemble`` (and the packed plan vector equal to
  JAX's), flat, classed and with speaker embeddings;
- a trainer with ``device_cache="on"`` and ``steps_per_dispatch=2``
  equal to the streaming single-step run with dropout and zoneout on
  (``tests/test_device_cache.py:106-134``'s tolerances);
- the ``auto``/``on`` gate;
- the train-mode draws: keep rates, different masks at different steps,
  the same masks for the same seed, nothing read from the host;
- the hand-built backward and remat against autograd over the whole loss
  with the masks drawn from the step's generator: the loss bit-equal.
"""

import json
import os

import numpy as np
import pytest
import torch
import jax

from fcl_taco2_tpu.data import BatchConverter as JaxConverter
from fcl_taco2_tpu.data import load_manifest as jax_manifest
from fcl_taco2_tpu.data.device_cache import DeviceBatchCache as JaxCache
from fcl_taco2_tpu_torch.data.converter import BatchConverter
from fcl_taco2_tpu_torch.data.device_cache import (DeviceBatchCache,
                                                   estimate_cache_bytes)
from fcl_taco2_tpu_torch.data.manifest import load_manifest
from fcl_taco2_tpu_torch.models.taco2_sa import Tacotron2SA
from fcl_taco2_tpu_torch.train.loop import TrainConfig, Trainer
from fcl_taco2_tpu_torch.train.step import step_generator

from helpers import tiny_config
from test_data_pipeline import write_corpus
from torch_port_helpers import port_batch, port_config

VJP_RTOL = 1e-5


def _assert_batches_equal(got, want):
    """Every leaf bit-equal, dtypes included."""
    for k, w in want._asdict().items():
        g = getattr(got, k)
        if k == "seg_classes":
            assert (g is None) == (w is None)
            for gc, wc in zip(g or (), w or ()):
                for f in wc._fields:
                    a, b = np.asarray(getattr(gc, f)), np.asarray(
                        getattr(wc, f))
                    assert a.dtype == b.dtype, f
                    np.testing.assert_array_equal(a, b, err_msg=f)
            continue
        if w is None:
            assert g is None, k
            continue
        a, b = np.asarray(g), np.asarray(w)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("classes,spk", [((), 0), ((2, 4, 6), 0), ((), 5)],
                         ids=["flat", "classed", "spembs"])
def test_assemble_bit_equal_to_converter_and_jax(tmp_path, classes, spk):
    corpus = write_corpus(str(tmp_path), n_utts=7, spk_embed_dim=spk)
    kw = dict(max_dur=6, batch_size=4, odim=8, tok_bucket=4, frame_bucket=8,
              seg_bucket=8, duration_classes=classes)
    utts, jutts = load_manifest(corpus), jax_manifest(corpus)
    conv = BatchConverter(cache={}, **kw).fit_corpus(utts)
    jconv = JaxConverter(cache={}, **kw).fit_corpus(jutts)
    dc = DeviceBatchCache(conv, utts, device="cpu")
    jdc = JaxCache(jconv, jutts, device=jax.devices("cpu")[0])
    assert dc.bytes == jdc.bytes
    assert dc.bytes <= estimate_cache_bytes(conv, len(utts), spk)
    for i in (0, 4):  # a full batch and a short (padded) one
        pack = dc.plan(utts[i:i + 4])
        jpack, layout = jdc.plan(jutts[i:i + 4])
        np.testing.assert_array_equal(pack, jpack)
        assert dc.layout == layout
        got = dc.assemble(torch.from_numpy(pack))
        _assert_batches_equal(got, conv(utts[i:i + 4]))
        _assert_batches_equal(got, jdc.assemble((jpack, layout)))


def _run(tmp_path, tag, **kw):
    """Two epochs of a tiny trainer with every dropout and zoneout on."""
    utts = load_manifest(write_corpus(str(tmp_path), n_utts=12))
    cfg = port_config(tiny_config(zoneout_rate=0.3, dropout_rate=0.3))
    exp = str(tmp_path / f"exp_{tag}")
    trainer = Trainer(Tacotron2SA(cfg, device="cpu", seed=0),
                      TrainConfig(exp_dir=exp, epochs=2, batch_size=3,
                                  seed=3, plot_interval_epochs=0, **kw),
                      utts[:10], utts[10:], device="cpu")
    ts = trainer.run()
    with open(os.path.join(exp, "log.jsonl")) as f:
        return trainer, ts, [json.loads(line) for line in f]


@pytest.mark.parametrize("cache", ["on", "off"])
def test_chained_run_equals_the_streaming_run(tmp_path, cache):
    """steps_per_dispatch=2 (4 batches an epoch: two chains of two), with
    the device cache (plan packs) or without it (streamed batches),
    against device_cache=off, one step a dispatch, with dropout and
    zoneout on: per-epoch losses within 1e-6 relative, the parameters
    within 1e-6 / 1e-7 (``tests/test_device_cache.py``)."""
    t_off, ts_off, log_off = _run(tmp_path, "off", device_cache="off",
                                  steps_per_dispatch=1)
    t_on, ts_on, log_on = _run(tmp_path, "on", device_cache=cache,
                               steps_per_dispatch=2)
    assert t_off._dcache is None
    assert (t_on._dcache is not None) == (cache == "on")
    assert t_on.chain_step is not None and t_off.chain_step is None
    assert [r["dispatches"] for r in log_on] == [2, 2]
    assert [r["steps_per_dispatch"] for r in log_on] == [2, 2]
    assert ts_on.step == ts_off.step == 8
    for a, b in zip(log_off, log_on):
        for k in ("main/loss", "validation/main/loss", "main/grad_norm"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-6)
    for (n, a), b in zip(ts_off.model.state_dict().items(),
                         ts_on.model.state_dict().values()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=n)


def test_auto_and_on_gate(tmp_path, capsys):
    """auto: the cache when it fits (and 4 steps a dispatch), streaming
    with the reason printed when it does not or cannot; on: raises
    where the cache cannot be built."""
    utts = load_manifest(write_corpus(str(tmp_path), n_utts=8))
    cfg = port_config(tiny_config())
    conf = tmp_path / "conf.json"
    conf.write_text(json.dumps({"process": [{"type": "gain"}]}))

    def trainer(**kw):
        return Trainer(Tacotron2SA(cfg, device="cpu"),
                       TrainConfig(exp_dir=str(tmp_path / "exp"),
                                   batch_size=4, **kw),
                       utts[:6], utts[6:], device="cpu")

    t = trainer()
    assert t._dcache is not None and t._spd == 4
    assert trainer(device_cache="off")._spd == 1
    for kw, why in ((dict(device_cache_max_mb=0), "exceeds"),
                    (dict(preprocess_conf=str(conf)), "preprocess_conf"),
                    (dict(fixed_shapes=False), "fixed_shapes")):
        capsys.readouterr()
        t = trainer(**kw)
        assert t._dcache is None and t._spd == 1
        assert why in capsys.readouterr().out
    for kw, why in ((dict(preprocess_conf=str(conf)), "preprocess_conf"),
                    (dict(fixed_shapes=False), "fixed_shapes")):
        with pytest.raises(ValueError, match=why):
            trainer(device_cache="on", **kw)
    with pytest.raises(ValueError, match="fixed_shapes"):
        trainer(device_cache="off", fixed_shapes=False,
                steps_per_dispatch=2)


def test_eval_with_the_cache_covers_the_validation_split(tmp_path):
    """5 validation utterances at batch 4 through the cache: plans of 4
    and 1 (the last padded with the zero row), weighted by their real
    utterances."""
    utts = load_manifest(write_corpus(str(tmp_path), n_utts=9))
    trainer = Trainer(Tacotron2SA(port_config(tiny_config()), device="cpu"),
                      TrainConfig(exp_dir=str(tmp_path / "exp"),
                                  batch_size=4),
                      utts[:4], utts[4:], device="cpu")
    seen = []
    orig = trainer._dcache.plan
    trainer._dcache.plan = lambda u: seen.append(len(u)) or orig(u)
    trainer.evaluate(trainer.init_state(), 0)
    assert sorted(seen) == [1, 4]
    assert trainer.reporter._counts["validation/main/loss"] == 5


def _taps(model, batch, seed, step):
    model.decoder.mask_taps = taps = []
    try:
        loss, _ = model.loss_fn(batch, step_generator(seed, step, "cpu"))
    finally:
        model.decoder.mask_taps = None
    return float(loss.detach()), taps


def _classed_batch(cfg, seed=0):
    from helpers import synthetic_batch, with_duration_classes
    return port_batch(with_duration_classes(
        synthetic_batch(cfg, B=4, Tmax=6, seed=seed, n_seg=24),
        cfg.effective_duration_classes))


def test_train_draws_follow_the_step_seed():
    """The zoneout masks of a step: one draw per class scan from the
    step's generator, Bernoulli(rate); another step draws other masks, the
    same (seed, step) the same masks and loss."""
    jcfg = tiny_config(zoneout_rate=0.3, dropout_rate=0.3,
                       duration_classes=(2, 4))
    model = Tacotron2SA(port_config(jcfg), device="cpu", seed=0)
    batch = _classed_batch(model.cfg)
    l0, t0 = _taps(model, batch, 5, 0)
    l0b, t0b = _taps(model, batch, 5, 0)
    l1, t1 = _taps(model, batch, 5, 1)
    assert len(t0) == len(model.cfg.effective_duration_classes)
    assert l0 == l0b and all(torch.equal(a, b) for a, b in zip(t0, t0b))
    assert l0 != l1 and not all(torch.equal(a, b) for a, b in zip(t0, t1))
    for t, D_c in zip(t0, model.cfg.effective_duration_classes):
        assert t.dtype == torch.bool
        assert t.shape[:2] == (D_c, 2 * model.cfg.dlayers)
    keep = torch.cat([t.flatten() for t in t0 + t1]).float().mean()
    assert abs(float(keep) - 0.3) < 0.02


def test_keep_rates_of_the_generator_draws():
    """Zoneout (keep-old) and dropout (keep) rates of the draws the train
    step makes from its generator, at sizes where the rate is sharp."""
    from fcl_taco2_tpu_torch.models.components import maybe_dropout
    from fcl_taco2_tpu_torch.ops.rnn import zoneout_keep_masks
    gen = step_generator(0, 7, "cpu")
    for rate in (0.1, 0.5):
        m = zoneout_keep_masks(gen, None, (8, 4), 64, 256, rate)
        assert m.shape == (8, 4, 64, 256)
        assert abs(m.float().mean().item() - rate) < 5e-3
        x = torch.ones(512, 1024)
        d = maybe_dropout(x, rate, gen, train=True)
        assert abs((d > 0).float().mean().item() - (1 - rate)) < 5e-3
    a = zoneout_keep_masks(step_generator(0, 7, "cpu"), None, (2, 4), 8, 8,
                           0.5)
    b = zoneout_keep_masks(step_generator(0, 8, "cpu"), None, (2, 4), 8, 8,
                           0.5)
    assert not torch.equal(a, b)


@pytest.mark.parametrize("classed", [False, True],
                         ids=["single_class", "classed"])
def test_backward_paths_bit_equal_on_the_loss(classed):
    """The whole ``loss_fn`` with dropout 0.3 and zoneout 0.3 drawn from
    the step's generator: autograd through the plain loop, the hand-built
    backward and remat give the same loss, bit for bit, and gradients
    within 1e-5."""
    from helpers import synthetic_batch
    jcfg = tiny_config(zoneout_rate=0.3, dropout_rate=0.3,
                       duration_classes=(2, 4) if classed else ())
    model = Tacotron2SA(port_config(jcfg), device="cpu", seed=0)
    batch = _classed_batch(model.cfg) if classed else port_batch(
        synthetic_batch(jcfg, B=4, Tmax=6, n_seg=24))
    params = list(model.parameters())
    base = model.cfg
    out = []
    for over in (dict(decoder_custom_vjp=False), {},
                 dict(remat_decoder=True)):
        model.cfg = base.replace(**over)
        loss, _ = model.loss_fn(batch, step_generator(1, 2, "cpu"))
        out.append((float(loss), torch.autograd.grad(loss, params)))
    model.cfg = base
    (l0, g0), *rest = out
    for l1, g1 in rest:
        assert l1 == l0
        err = max(float((a - b).abs().max() / (1e-8 + a.abs().max()))
                  for a, b in zip(g0, g1))
        assert err < VJP_RTOL, err
