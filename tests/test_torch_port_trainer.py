"""The port's data path and trainer on the CPU.

- ``BatchConverter`` and the segment plans give the JAX package's arrays,
  exactly, on the same utterances.
- ``python -m fcl_taco2_tpu_torch.cli.fcl_train --device cpu``: the loss
  falls over two tiny epochs, an interrupted and resumed run ends with the
  same parameters as an uninterrupted one, exactly, and the files it
  writes restore.
- The non-finite guard skips a step whose gradients hold a NaN.
"""

import json
import os

import numpy as np
import pytest
import torch

from fcl_taco2_tpu.data.converter import BatchConverter as JaxConverter
from fcl_taco2_tpu.data.manifest import load_manifest as jax_manifest
from fcl_taco2_tpu.ops import regroup as jax_regroup
from fcl_taco2_tpu_torch.cli.fcl_train import main
from fcl_taco2_tpu_torch.data.converter import BatchConverter
from fcl_taco2_tpu_torch.data.manifest import load_manifest
from fcl_taco2_tpu_torch.data.synthetic import write_learnable_corpus
from fcl_taco2_tpu_torch.models.taco2_sa import Tacotron2SA
from fcl_taco2_tpu_torch.ops import regroup
from fcl_taco2_tpu_torch.train import checkpoint as ckpt
from fcl_taco2_tpu_torch.train.loop import TrainConfig, Trainer

from test_data_pipeline import write_corpus
from torch_port_helpers import port_config
from helpers import tiny_config

TINY = ["--embed-dim", "16", "--eunits", "16", "--econv-chans", "16",
        "--dunits", "20", "--prenet-units", "12", "--postnet-chans", "10",
        "--duration-predictor-chans", "14", "--max-dur", "6",
        "--duration-classes", "3", "--compute-dtype", "float32",
        "--batch-size", "4", "--device", "cpu"]


def _assert_batches_equal(a, b):
    for k, x in a._asdict().items():
        y = getattr(b, k)
        if k == "seg_classes":
            assert (x is None) == (y is None)
            for ca, cb in zip(x or (), y or ()):
                for u, v in zip(ca, cb):
                    np.testing.assert_array_equal(np.asarray(u),
                                                  np.asarray(v))
            continue
        if x is None or y is None:
            assert x is None and y is None, k
            continue
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("classes", [(), (2, 4, 6)])
def test_converter_matches_jax(tmp_path, classes):
    corpus = write_corpus(str(tmp_path), n_utts=9)
    utts, jutts = load_manifest(corpus), jax_manifest(corpus)
    assert [u.uttid for u in utts] == [u.uttid for u in jutts]
    kw = dict(max_dur=6, batch_size=4, odim=8, duration_classes=classes)
    conv = BatchConverter(**kw).fit_corpus(utts)
    jconv = JaxConverter(**kw).fit_corpus(jutts)
    assert conv.class_caps == jconv.class_caps
    for i in range(0, 9, 4):  # the last batch is padded with empty rows
        _assert_batches_equal(jconv(jutts[i:i + 4]), conv(utts[i:i + 4]))
    # bucketed shapes (no corpus fit) too
    _assert_batches_equal(JaxConverter(**kw)(jutts[:3]),
                          BatchConverter(**kw)(utts[:3]))


def test_plan_builders_match_jax():
    rng = np.random.default_rng(0)
    dur = rng.integers(0, 9, (5, 12)).astype(np.int32)
    olens = dur.sum(1)
    Lmax = int(olens.max()) + 3
    a = regroup.build_plan(dur, olens, 8, 64, Lmax)
    b = jax_regroup.build_plan(dur, olens, 8, 64, Lmax)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    caps = regroup.duration_class_caps(list(dur), (2, 4, 8), 5, 8)
    assert caps == jax_regroup.duration_class_caps(list(dur), (2, 4, 8), 5,
                                                   8)
    a = regroup.build_classed_plan(dur, olens, (2, 4, 8), caps, Lmax)
    b = jax_regroup.build_classed_plan(dur, olens, (2, 4, 8), caps, Lmax)
    np.testing.assert_array_equal(a.utt_gather, b.utt_gather)
    for ca, cb in zip(a.classes, b.classes):
        for x, y in zip(ca, cb):
            np.testing.assert_array_equal(x, y)


def _epochs(exp):
    with open(os.path.join(exp, "log.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_cli_trains_and_resumes_exactly(tmp_path):
    train, valid = write_learnable_corpus(str(tmp_path), 16, 4)
    base = ["--train-json", train, "--valid-json", valid, *TINY]
    full = str(tmp_path / "full")
    ts_full = main(base + ["--outdir", full, "--epochs", "2"])
    log = _epochs(full)
    assert log[1]["main/loss"] < log[0]["main/loss"]
    assert ts_full.step == 8
    for name in ("model.json", "snapshot.ep.1", "snapshot.ep.2",
                 "model.loss.best"):
        assert os.path.exists(os.path.join(full, name)), name
    cfg, _ = ckpt.load_model_json(full)
    restored = ckpt.load_params_only(os.path.join(full, "snapshot.ep.2"),
                                     Tacotron2SA(cfg, device="cpu", seed=9))
    for a, b in zip(ts_full.model.state_dict().values(),
                    restored.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)

    cut = str(tmp_path / "cut")
    main(base + ["--outdir", cut, "--epochs", "1"])
    ts_res = main(base + ["--outdir", cut, "--epochs", "2", "--resume",
                          os.path.join(cut, "snapshot.ep.1")])
    assert ts_res.step == 8
    for a, b in zip(ts_full.model.state_dict().values(),
                    ts_res.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for k in ("mu", "nu"):
        for a, b in zip(ts_full.opt_state[k], ts_res.opt_state[k]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_nan_guard_skips_the_bad_step(tmp_path):
    train, valid = write_learnable_corpus(str(tmp_path), 8, 2, nan_utt=0)
    cfg = port_config(tiny_config(max_dur=6))
    model = Tacotron2SA(cfg, device="cpu", seed=0)
    tcfg = TrainConfig(exp_dir=str(tmp_path / "exp"), epochs=1,
                       batch_size=4, plot_interval_epochs=0)
    trainer = Trainer(model, tcfg, load_manifest(train),
                      load_manifest(valid), device="cpu")
    ts = trainer.run()
    assert ts.step == 2
    assert ts.opt_state["total_notfinite"] == 1
    assert ts.opt_state["count"] == 1
    for p in ts.model.parameters():
        assert torch.isfinite(p).all()


def test_sigterm_checkpoints_after_the_inflight_step(tmp_path):
    """SIGTERM during a step: the step finishes, snapshot.preempt holds
    its state at the cut epoch's index, and run() returns."""
    import signal

    train, valid = write_learnable_corpus(str(tmp_path), 12, 2)
    cfg = port_config(tiny_config(max_dur=6))
    tcfg = TrainConfig(exp_dir=str(tmp_path / "exp"), epochs=3,
                       batch_size=4, plot_interval_epochs=0,
                       checkpoint_on_signal=True)
    trainer = Trainer(Tacotron2SA(cfg, device="cpu", seed=0), tcfg,
                      load_manifest(train), load_manifest(valid),
                      device="cpu")
    step = trainer.train_step

    def step_then_signal(ts, batch, gen):
        out = step(ts, batch, gen)
        if out[0].step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    trainer.train_step = step_then_signal
    before = signal.getsignal(signal.SIGTERM)
    ts = trainer.run()
    assert signal.getsignal(signal.SIGTERM) is before
    assert ts.step == 2
    payload = ckpt.read_checkpoint(str(tmp_path / "exp" / "snapshot.preempt"))
    assert (payload["step"], payload["epoch"]) == (2, 0)
    assert not os.path.exists(tmp_path / "exp" / "snapshot.ep.1")


def test_eval_covers_the_whole_validation_split(tmp_path):
    """5 validation utterances at batch 4: chunks of 4 and 1 (the trailing
    one padded with empty rows), weighted by their real utterances."""
    train, valid = write_learnable_corpus(str(tmp_path), 4, 5)
    cfg = port_config(tiny_config(max_dur=6))
    trainer = Trainer(Tacotron2SA(cfg, device="cpu", seed=0),
                      TrainConfig(exp_dir=str(tmp_path / "exp"),
                                  batch_size=4, device_cache="off"),
                      load_manifest(train), load_manifest(valid),
                      device="cpu")
    seen = []
    orig = trainer.converter
    trainer.converter = lambda utts: seen.append(len(utts)) or orig(utts)
    trainer.evaluate(trainer.init_state(), 0)
    assert sorted(seen) == [1, 4]
    assert trainer.reporter._counts["validation/main/loss"] == 5
