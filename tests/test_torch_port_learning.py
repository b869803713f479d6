"""The port must LEARN: the counterpart of
``tests/test_learning.py::test_pipeline_learns_to_reconstruct``.

The same corpus (mels a deterministic function of phoneme identity:
signature + intra-phoneme ramp), the same model and training settings and
the same overlapping split (``utts[:10]`` train, ``utts[:2]``
validation), through the port's ``Trainer`` on the CPU with its defaults:
the device cache (built on the CPU too) and chained steps.  JAX's two
conditions hold: the last logged loss under a quarter of the first, and
the AR decode with ground-truth durations far under the predict-the-mean
floor (~0.8).  The overlapping split is what the JAX trainer's device
cache rejects (``fcl_taco2_tpu/data/device_cache.py:116-117``: both of the
reference's red tests fail there); the port shares the row, and a short
run shows its losses equal the streamed path's bit for bit.
"""

import json
import os

import numpy as np
import pytest
import torch

from fcl_taco2_tpu_torch.data import load_manifest
from fcl_taco2_tpu_torch.data.converter import BatchConverter
from fcl_taco2_tpu_torch.data.device_cache import DeviceBatchCache
from fcl_taco2_tpu_torch.data.manifest import load_features
from fcl_taco2_tpu_torch.infer import Synthesizer
from fcl_taco2_tpu_torch.infer.metrics import mel_l1
from fcl_taco2_tpu_torch.models import Tacotron2SA
from fcl_taco2_tpu_torch.train.loop import TrainConfig, Trainer

from helpers import tiny_config
from test_learning import ODIM, V, write_learnable_corpus
from torch_port_helpers import port_config

CFG = dict(idim=V + 1, odim=ODIM, max_dur=10, eunits=32, embed_dim=32,
           econv_chans=32, dunits=64, prenet_units=24, postnet_chans=24,
           dropout_rate=0.1, zoneout_rate=0.05)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny models: one intra-op thread is as fast, and the test workers
    sharing the cores do not oversubscribe them (spinning thread pools
    slowed these tests twentyfold under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _train(root, epochs, **kw):
    """The JAX test's trainer on the port: batch 5, lr 2e-3, 10 training
    and 2 (overlapping) validation utterances; returns (model, final
    state, trainer, log rows)."""
    utts = load_manifest(write_learnable_corpus(root))
    model = Tacotron2SA(port_config(tiny_config(**CFG)), device="cpu",
                        seed=0)
    exp = os.path.join(root, "exp")
    tcfg = TrainConfig(exp_dir=exp, epochs=epochs, batch_size=5, lr=2e-3,
                       eval_interval_epochs=epochs,
                       save_interval_epochs=epochs, plot_interval_epochs=0,
                       **kw)
    trainer = Trainer(model, tcfg, utts[:10], utts[:2], device="cpu")
    trainer.run()
    with open(os.path.join(exp, "log.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return model, utts, trainer, rows


def test_pipeline_learns_to_reconstruct(tmp_path):
    model, utts, trainer, rows = _train(str(tmp_path), 120)
    assert trainer._dcache is not None and trainer.chain_step is not None
    losses = [r["main/loss"] for r in rows]
    assert losses[-1] < losses[0] * 0.25, (losses[0], losses[-1])

    synth = Synthesizer(model, batch_size=4, device="cpu")
    chunk = utts[:4]
    durs = [load_features(u)[1] for u in chunk]
    mels, _ = synth.synth_batch([u.tokenids for u in chunk], 0,
                                durations=durs)
    l1 = float(np.mean([mel_l1(m, load_features(u)[0])
                        for u, m in zip(chunk, mels)]))
    # the predict-the-mean floor of these targets is ~0.8; the AR decode
    # (prenet dropout stays on) must do clearly better
    assert l1 < 0.65, l1


@pytest.mark.parametrize("cache", ["auto", "on"])
def test_overlapping_split_equals_the_streamed_run(tmp_path, cache):
    """Validation utterances that are training ones: the cache holds one
    row an uttid, and 3 epochs give the streamed path's losses (train and
    validation) bit for bit."""
    _, _, t_off, off = _train(str(tmp_path / "off"), 3, device_cache="off")
    _, _, t_on, on = _train(str(tmp_path / "on"), 3, device_cache=cache)
    assert t_off._dcache is None
    assert len(t_on._dcache._host_dur) == 10  # 10 train + 2 shared
    for a, b in zip(off, on):
        for k in ("main/loss", "main/grad_norm"):
            assert a[k] == b[k], (k, a[k], b[k])
    assert off[-1]["validation/main/loss"] == on[-1]["validation/main/loss"]


def test_same_uttid_other_features_raises(tmp_path):
    """One uttid, two feature files: the cache names both and refuses."""
    utts = load_manifest(write_learnable_corpus(str(tmp_path)))
    clash = utts[1]._replace(uttid=utts[0].uttid)
    conv = BatchConverter(batch_size=5, odim=ODIM, max_dur=10,
                          cache={}).fit_corpus(utts[:3])
    with pytest.raises(ValueError, match="different features") as e:
        DeviceBatchCache(conv, [utts[0], utts[2], clash], device="cpu")
    assert utts[0].mel_path in str(e.value)
    assert utts[1].mel_path in str(e.value)
