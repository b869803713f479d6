"""Preprocessing in the port (``fcl_taco2_tpu_torch/ops/{stft,f0}.py``,
``audio/{textgrid,synthcorpus,preprocess}.py``, ``cli/fcl_preprocess.py``)
held to the JAX package on the same inputs, on the CPU:

- the mel filterbank and window equal to JAX's; ``stft_mag`` / ``logmel``
  / ``frame_energy`` on seeded wavs of odd lengths: log-mel within 1e-4
  abs, magnitude and energy within 1e-5 of their max;
- ``yin_f0`` on the seven F0 golden signals: voicing equal on every
  frame, f0 within 1e-5 relative; and the port alone meets
  ``tests/test_f0_goldens.py``'s budgets;
- TextGrid parsing, alignment and vocab on long- and short-format files
  equal to JAX's; ``generate_corpus`` byte-equal;
- ``run_preprocess`` on ``tests/test_preprocess.py::make_corpus`` in both
  packages (several length buckets): vocab and manifests equal once the
  feature roots are swapped, durations exact, normalized features within
  1e-4 abs, stats within 1e-5 relative; the port's manifests train one
  CPU epoch; ``fcl_preprocess --device cpu`` writes the same files.
"""

import json
import os

import numpy as np
import pytest
import torch

from fcl_taco2_tpu.audio import preprocess as jax_pre
from fcl_taco2_tpu.audio import synthcorpus as jax_corpus
from fcl_taco2_tpu.audio import textgrid as jax_tg
from fcl_taco2_tpu.ops import stft as jax_stft
from fcl_taco2_tpu.ops.f0 import yin_f0 as jax_yin
from fcl_taco2_tpu_torch.audio import preprocess as port_pre
from fcl_taco2_tpu_torch.audio import synthcorpus as port_corpus
from fcl_taco2_tpu_torch.audio import textgrid as port_tg
from fcl_taco2_tpu_torch.ops import stft as port_stft
from fcl_taco2_tpu_torch.ops.f0 import yin_f0

from test_f0_goldens import BUDGETS, FIXTURE, _metrics
from test_preprocess import make_corpus, write_textgrid

FEATURES = ("mels", "f0", "en")
# several buckets of the 6-utterance corpus, two in flight at a time
BATCH_FRAMES = 2 ** 15


def test_filterbank_and_window_equal_jax():
    for args in ((22050, 1024, 80, 80.0, 7600.0), (16000, 512, 40, 0, None)):
        np.testing.assert_array_equal(port_stft.mel_filterbank(*args),
                                      jax_stft.mel_filterbank(*args))
    np.testing.assert_array_equal(port_stft.hann_window(1024),
                                  jax_stft.hann_window(1024))


@pytest.mark.parametrize("n,win", [(5001, None), (12345, 800)])
def test_stft_features_match_jax(n, win):
    x = (0.3 * np.random.default_rng(n).normal(size=(2, n))).astype(
        np.float32)
    xt = torch.from_numpy(x)
    mag_j = np.asarray(jax_stft.stft_mag(x, win_length=win))
    mag_p = port_stft.stft_mag(xt, win_length=win).numpy()
    assert mag_p.shape == mag_j.shape == (2, 1 + n // 256, 513)
    assert np.abs(mag_p - mag_j).max() <= 1e-5 * np.abs(mag_j).max()
    mel_j = np.asarray(jax_stft.logmel(x, win_length=win))
    np.testing.assert_allclose(port_stft.logmel(xt, win_length=win).numpy(),
                               mel_j, rtol=0, atol=1e-4)
    en_j = np.asarray(jax_stft.frame_energy(x, win_length=win))
    en_p = port_stft.frame_energy(xt, win_length=win).numpy()
    assert np.abs(en_p - en_j).max() <= 1e-5 * en_j.max()


def test_reflect_pad_longer_than_the_row_raises():
    with pytest.raises(ValueError, match="reflect padding"):
        port_stft.stft_mag(torch.zeros(300))


def _golden_signals():
    z = np.load(FIXTURE)
    names = sorted({k.rsplit("_", 1)[0] for k in z.files
                    if k.endswith("_signal")})
    return {n: (z[f"{n}_signal"].astype(np.float32) / 32767.0, z[f"{n}_f0"])
            for n in names}


def test_yin_matches_jax_and_meets_the_goldens():
    signals = _golden_signals()
    assert set(signals) == set(BUDGETS)
    failures = []
    for name, (x, truth) in signals.items():
        want = np.asarray(jax_yin(x))
        got = yin_f0(x, device="cpu").numpy()
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got > 0, want > 0, err_msg=name)
        v = want > 0
        np.testing.assert_allclose(got[v], want[v], rtol=1e-5, atol=0,
                                   err_msg=name)
        f1, med_cents, octave = _metrics(got, truth)
        min_f1, max_cents, max_oct = BUDGETS[name]
        if f1 < min_f1 or med_cents > max_cents or octave > max_oct:
            failures.append(f"{name}: F1={f1:.3f}, cents={med_cents:.1f}, "
                            f"octave={octave:.3f}")
    assert not failures, failures


def test_yin_batched_rows_equal_single_rows():
    """One (B, N) call gives each row's single-row result (zero-padded
    rows, as the frontend's buckets hold them)."""
    signals = [x for x, _ in _golden_signals().values()]
    N = max(len(x) for x in signals)
    batch = np.zeros((len(signals), N), np.float32)
    for r, x in enumerate(signals):
        batch[r, :len(x)] = x
    got = yin_f0(batch, device="cpu")
    for r in range(len(signals)):
        torch.testing.assert_close(got[r], yin_f0(batch[r], device="cpu"),
                                   rtol=0, atol=0)


def _write_short_textgrid(path, intervals):
    xmax = intervals[-1][1]
    lines = ['File type = "ooTextFile"', 'Object class = "TextGrid"', "",
             "0", str(xmax), "<exists>", "1", '"IntervalTier"', '"phones"',
             "0", str(xmax), str(len(intervals))]
    for a, b, t in intervals:
        lines += [str(a), str(b), f'"{t}"']
    with open(path, "w", encoding="utf-16") as f:
        f.write("\n".join(lines))


def test_textgrid_alignment_and_vocab_equal_jax(tmp_path):
    segs = [(0.0, 0.31, "HH"), (0.31, 0.52, "AH"), (0.52, 0.8, "sp"),
            (0.8, 1.013, "")]
    paths = [str(tmp_path / "long.TextGrid"), str(tmp_path / "short.TextGrid")]
    write_textgrid(paths[0], segs)
    _write_short_textgrid(paths[1], segs[:2] + [(0.52, 0.9, 'say ""hi""')])
    for p in paths:
        assert port_tg.read_textgrid(p) == jax_tg.read_textgrid(p)
        assert port_pre.alignment_from_textgrid(p, 22050, 256) == \
            jax_pre.alignment_from_textgrid(p, 22050, 256)
    assert port_pre.build_vocab(paths) == jax_pre.build_vocab(paths)


def test_generate_corpus_is_byte_equal(tmp_path):
    a = port_corpus.generate_corpus(str(tmp_path / "port"), n_utts=3,
                                    seed=0)
    b = jax_corpus.generate_corpus(str(tmp_path / "jax"), n_utts=3, seed=0)
    for sub in ("wavs", "tg"):
        names = sorted(os.listdir(os.path.join(a, sub)))
        assert names == sorted(os.listdir(os.path.join(b, sub)))
        assert len(names) == 3
        for n in names:
            with open(os.path.join(a, sub, n), "rb") as fa, \
                    open(os.path.join(b, sub, n), "rb") as fb:
                assert fa.read() == fb.read(), (sub, n)


def _config(mod, root, feat, **kw):
    kw.setdefault("batch_frames", BATCH_FRAMES)
    return mod.PreprocessConfig(
        data_root=root, feature_root=feat,
        textgrid_root=os.path.join(root, "tg"), n_val=1, n_test=1,
        max_dur=50, **kw)


@pytest.fixture(scope="module")
def preprocessed(tmp_path_factory):
    """One corpus through each package's ``run_preprocess``."""
    base = tmp_path_factory.mktemp("pre")
    root = make_corpus(str(base / "corpus"))
    out = {}
    for name, mod, kw in (("jax", jax_pre, {}),
                          ("port", port_pre, {"device": "cpu"})):
        feat = str(base / name)
        splits, stats = mod.run_preprocess(_config(mod, root, feat, **kw),
                                           log=lambda *a: None)
        out[name] = (feat, splits, stats)
    out["root"] = root
    return out


def _read(feat, name):
    with open(os.path.join(feat, name)) as f:
        return f.read().replace(feat, "<features>")


def test_preprocess_files_match_jax(preprocessed):
    fj, splits_j, stats_j = preprocessed["jax"]
    fp, splits_p, stats_p = preprocessed["port"]
    assert splits_p == splits_j
    for name in ("phn2idx.json", "train_data.json", "val_data.json",
                 "test_data.json"):
        assert _read(fp, name) == _read(fj, name), name
    for k, v in stats_j.items():
        v = np.asarray(v)
        np.testing.assert_allclose(np.asarray(stats_p[k]), v, rtol=1e-5,
                                   atol=1e-5 * np.abs(v).max(), err_msg=k)
    for name in ("mel_stats.npy", "f0_en_stats.npy"):
        a, b = np.load(os.path.join(fj, name)), np.load(os.path.join(fp, name))
        assert a.dtype == b.dtype and a.shape == b.shape
    for sub in ("durations_MFA", "durations_MFA-ori") + FEATURES:
        names = sorted(os.listdir(os.path.join(fj, sub)))
        assert names == sorted(os.listdir(os.path.join(fp, sub)))
        assert len(names) == 6
        for n in names:
            a = np.load(os.path.join(fj, sub, n))
            b = np.load(os.path.join(fp, sub, n))
            assert a.dtype == b.dtype and a.shape == b.shape, (sub, n)
            if sub in FEATURES:
                np.testing.assert_allclose(b, a, rtol=0, atol=1e-4,
                                           err_msg=f"{sub}/{n}")
            else:
                np.testing.assert_array_equal(b, a, err_msg=f"{sub}/{n}")


def test_preprocessed_manifest_trains_one_epoch(preprocessed, tmp_path):
    from fcl_taco2_tpu_torch.data.manifest import load_manifest
    from fcl_taco2_tpu_torch.models import Tacotron2SA
    from fcl_taco2_tpu_torch.train.loop import TrainConfig, Trainer
    from helpers import tiny_config
    from torch_port_helpers import port_config

    feat = preprocessed["port"][0]
    with open(os.path.join(feat, "phn2idx.json")) as f:
        n_vocab = len(json.load(f))
    utts = load_manifest(os.path.join(feat, "train_data.json"))
    assert len(utts) == 4
    model = Tacotron2SA(port_config(tiny_config(idim=n_vocab, odim=80,
                                                max_dur=50)), device="cpu")
    tcfg = TrainConfig(exp_dir=str(tmp_path / "exp"), epochs=1,
                       batch_size=4, plot_interval_epochs=0)
    Trainer(model, tcfg, utts,
            load_manifest(os.path.join(feat, "val_data.json")),
            device="cpu").run()
    with open(tmp_path / "exp" / "log.jsonl") as f:
        assert np.isfinite(json.loads(f.readline())["main/loss"])


def test_cli_matches_run_preprocess(preprocessed, tmp_path):
    """The CLI (default ``batch_frames``: one bucket here) writes what
    ``run_preprocess`` with the same settings writes, bit for bit."""
    from fcl_taco2_tpu_torch.cli import fcl_preprocess

    root = preprocessed["root"]
    fp = str(tmp_path / "direct")
    port_pre.run_preprocess(_config(port_pre, root, fp, device="cpu",
                                    batch_frames=2 ** 21),
                            log=lambda *a: None)
    feat = str(tmp_path / "cli")
    lines = []
    fcl_preprocess.main(["--data-root", root, "--feature-root", feat,
                         "--textgrid-root", os.path.join(root, "tg"),
                         "--n-val", "1", "--n-test", "1", "--device", "cpu"],
                        log=lines.append)
    assert sum(line.startswith("  stage ") for line in lines) == 5
    for name in ("phn2idx.json", "train_data.json", "val_data.json",
                 "test_data.json"):
        assert _read(feat, name) == _read(fp, name), name
    for sub in FEATURES + ("durations_MFA",):
        for n in sorted(os.listdir(os.path.join(fp, sub))):
            np.testing.assert_array_equal(
                np.load(os.path.join(feat, sub, n)),
                np.load(os.path.join(fp, sub, n)), err_msg=f"{sub}/{n}")
