"""The harness's output check on the CPU at tiny widths: a sound run is
correct, and a run whose program is broken underneath is not, once for
each fault a cell can have: an answer altered where it is produced, an
utterance's frames in reverse order and half of a batch left out
(serving); a step that leaves its state
unchanged and half of the batch left out of the loss's means (training).
The look for a card is skipped: the harness runs with ``device="cpu"``,
every other step as on the card."""

import json
import time

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TRAIN = {"corpus_size": 32, "batch": 8, "epochs": 3, "chain": 2,
         "max_steps_per_s": 200}
CELLS = {"student-tts-b1": ("fcl-taco2-S", {}),
         "teacher-synth-b16": ("fcl-taco2-T", {"batch": 4}),
         "teacher-train-b64": ("fcl-taco2-T", TRAIN)}
SERVING = ["student-tts-b1", "teacher-synth-b16"]


def run(cell, capsys, seed=2 ** 32 + 11):
    cfg, mix = CELLS[cell]
    spec = harness.load_spec(tiny.ROOT)
    rc = harness.run_cell(spec, cell, seed, 0.3, False, time.perf_counter(),
                          device="cpu",
                          config_override=tiny.config(cfg, "float32"),
                          mix_override=tiny.mix(**mix))
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _altered_mel(monkeypatch, rows):
    from fcl_taco2_tpu_torch.models.taco2_sa import Tacotron2SA
    real = Tacotron2SA.synthesize

    def synthesize(self, *a, **kw):
        out = real(self, *a, **kw)
        out["mel"] = rows(out["mel"].clone())
        return out
    monkeypatch.setattr(Tacotron2SA, "synthesize", synthesize)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(cell, capsys):
    res = run(cell, capsys)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", SERVING)
def test_an_altered_frame_fails(cell, capsys, monkeypatch):
    def alter(mel):
        mel[0, 5] += 1.0  # one frame of the first utterance
        return mel
    _altered_mel(monkeypatch, alter)
    assert not run(cell, capsys)["correct"]


@pytest.mark.parametrize("cell", SERVING)
def test_frames_in_reverse_order_fail(cell, capsys, monkeypatch):
    """A fault whose mean gap is nought: one utterance's frames reversed."""
    from fcl_taco2_tpu_torch.models.taco2_sa import Tacotron2SA
    real = Tacotron2SA.synthesize

    def synthesize(self, *a, **kw):
        out = real(self, *a, **kw)
        n = int(out["olens"][0])
        out["mel"] = out["mel"].clone()
        out["mel"][0, :n] = out["mel"][0, :n].flip(0)
        return out
    monkeypatch.setattr(Tacotron2SA, "synthesize", synthesize)
    res = run(cell, capsys)
    assert not res["correct"]
    if cell == "teacher-synth-b16":
        checks = res["checks"]
        assert checks["mel_bias_err"]["value"] <= \
            checks["mel_bias_err"]["limit"]
        assert checks["mel_max_err"]["value"] > checks["mel_max_err"]["limit"]


def test_an_altered_sample_fails(capsys, monkeypatch):
    from fcl_taco2_tpu_torch.infer import pipeline
    real = pipeline.vocode

    def vocode(*a, **kw):
        wav = real(*a, **kw).clone()
        wav[:, 100] += 0.5
        return wav
    monkeypatch.setattr(pipeline, "vocode", vocode)
    assert not run("student-tts-b1", capsys)["correct"]


def test_half_the_batch_left_out_fails(capsys, monkeypatch):
    def drop(mel):
        mel[mel.shape[0] // 2:] = 0.0
        return mel
    _altered_mel(monkeypatch, drop)
    assert not run("teacher-synth-b16", capsys)["correct"]


def test_a_step_that_leaves_the_state_unchanged_fails(capsys, monkeypatch):
    from fcl_taco2_tpu_torch.train import optim
    monkeypatch.setattr(optim.Optimizer, "update",
                        lambda self, params, grads, state: None)
    res = run("teacher-train-b64", capsys)
    assert not res["correct"]
    assert res["checks"]["change_med_gap"]["value"] > 0.99


def test_half_the_training_batch_left_out_fails(capsys, monkeypatch):
    from fcl_taco2_tpu_torch.models import components
    from fcl_taco2_tpu_torch.ops import masking
    real = masking.masked_mean

    def half(values, mask, count=None):
        mask = mask.clone()
        mask[mask.shape[0] // 2:] = False
        return real(values, mask, count)
    monkeypatch.setattr(masking, "masked_mean", half)
    monkeypatch.setattr(components, "masked_mean", half)
    assert not run("teacher-train-b64", capsys)["correct"]
