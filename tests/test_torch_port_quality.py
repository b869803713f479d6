"""The port's quality protocol (``scripts/torch_*``) against the JAX
scripts it copies, on the CPU:

- each ported metric function against its JAX counterpart on the same
  numpy inputs: ``duration_metrics``, ``oracle_metrics``,
  ``frame_truth``, ``phone_avg``, the calibration floors
  (``mcd_benchmark.py:141-160``) and the int8 codes, scales and weight
  SNR of ``torch_quant_quality`` (``quant_quality.py:89-110``);
- ``torch_mcd_benchmark.main`` end to end with ``--device cpu`` at tiny
  widths (a few utterances, 1 epoch, through ``--teacher-config`` and
  ``--student-config``): its JSON has the JAX record's keys; then the
  other four scripts on its workdir, each JSON with its JAX record's keys
  (``results/*.json``, less the hand-written commentary).
"""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import dur_quality as jax_dur  # noqa: E402
import f0_groundtruth_eval as jax_f0  # noqa: E402
import torch_decode_protocol  # noqa: E402
import torch_dur_quality  # noqa: E402
import torch_f0_groundtruth_eval  # noqa: E402
import torch_mcd_benchmark  # noqa: E402
import torch_quant_quality  # noqa: E402

TINY = {"embed-dim": 16, "eunits": 16, "econv-chans": 16,
        "prenet-units": 12, "postnet-layers": 3, "postnet-chans": 10,
        "duration-predictor-chans": 14, "compute-dtype": "float32"}
# a teacher the streaming decoder entry accepts (dunits % 256 == 0) and a
# student the resident one does
TEACHER = dict(TINY, dunits=256)
STUDENT = dict(TINY, dunits=20)
CURATED = {"notes", "conclusion", "note", "superseded_note", "observed"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny models: one intra-op thread is as fast, and the test workers
    sharing the cores do not oversubscribe them (spinning thread pools
    slowed these tests twentyfold under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_keys(name):
    """The keys a JAX quality script writes: its record's, less the
    hand-written commentary."""
    with open(os.path.join(REPO, "results", name)) as f:
        rec = json.load(f)
    return (set(rec) - CURATED,
            set(rec["protocol"]) - CURATED - {"backend"})


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """``torch_mcd_benchmark.main`` at tiny widths: 12 utterances (2
    validation, 3 test), 1 epoch of teacher and of KD, on the CPU."""
    root = tmp_path_factory.mktemp("mcd")
    confs = {}
    for tag, conf in (("teacher", TEACHER), ("student", STUDENT)):
        confs[tag] = str(root / f"{tag}.json")
        with open(confs[tag], "w") as f:
            json.dump(conf, f)
    wd = str(root / "wd")
    payload = torch_mcd_benchmark.main([
        "--device", "cpu", "--workdir", wd, "--n-utts", "12",
        "--n-val", "2", "--n-test", "3", "--epochs", "1",
        "--batch-size", "4", "--teacher-config", confs["teacher"],
        "--student-config", confs["student"],
        "--out", str(root / "TORCH_MCD_e2e.json")])
    return root, wd, payload


def test_mcd_benchmark_end_to_end_has_jax_keys(run):
    root, wd, payload = run
    with open(root / "TORCH_MCD_e2e.json") as f:
        assert json.load(f) == payload
    top, proto = _jax_keys("MCD_e2e.json")
    assert top <= set(payload) and proto <= set(payload["protocol"])
    assert payload["protocol"]["device"]["device"] == "cpu"
    with open(os.path.join(REPO, "results", "MCD_e2e.json")) as f:
        jax_results = json.load(f)["results"]
    tags = ("pred_dur", "gt_dur", "student_pred_dur", "student_gt_dur")
    assert set(payload["results"]) == set(tags)
    for tag in tags:
        got = payload["results"][tag]
        assert set(jax_results[tag]) == set(got), tag
        assert got["n_utts"] == 3
        assert all(np.isfinite(got[k]) for k in
                   ("mcd", "l1", "rmse", "frames_per_sec")), (tag, got)
    assert set(payload["floors"]) == {"predict_mean_mcd",
                                      "mismatched_utterance_mcd",
                                      "predict_mean_l1"}
    assert payload["teacher_train_wall_sec"] > 0
    assert payload["kd_train_wall_sec"] > 0


def test_floors_match_jax(run):
    """``floors`` against ``mcd_benchmark.py:141-160`` (through the JAX
    package's manifest and metrics) on the run's test shard."""
    from fcl_taco2_tpu.data import load_manifest
    from fcl_taco2_tpu.data.manifest import _load_feat
    from fcl_taco2_tpu.infer.metrics import (mel_cepstral_distortion,
                                             mel_l1)
    _, wd, payload = run
    feat = os.path.join(wd, "features")
    mean, std = np.load(os.path.join(feat, "mel_stats.npy"))
    mels = [_load_feat(u.mel_path, u.filetypes[0]) * std + mean
            for u in load_manifest(os.path.join(feat, "test_data.json"))]
    want = {
        "predict_mean_mcd": float(np.mean([
            mel_cepstral_distortion(np.broadcast_to(mean, m.shape), m)
            for m in mels])),
        "mismatched_utterance_mcd": float(np.mean([
            mel_cepstral_distortion(mels[(i + 1) % len(mels)], m)
            for i, m in enumerate(mels)])),
        "predict_mean_l1": float(np.mean([
            mel_l1(np.broadcast_to(mean, m.shape), m) for m in mels])),
    }
    assert torch_mcd_benchmark.floors(feat) == want == payload["floors"]


def test_duration_metrics_match_jax():
    rng = np.random.default_rng(0)
    gts = [rng.integers(0, 30, n) for n in (5, 9, 14, 3)]
    preds = [np.clip(g + rng.integers(-4, 5, len(g)), 0, 50) for g in gts]
    assert torch_dur_quality.duration_metrics(preds, gts) \
        == jax_dur.duration_metrics(preds, gts)


def test_oracle_metrics_match_jax(run):
    from fcl_taco2_tpu.data import load_manifest as jax_manifest
    from fcl_taco2_tpu.data.manifest import load_durations as jax_durations
    from fcl_taco2_tpu_torch.data import load_manifest
    _, wd, _ = run
    feat = os.path.join(wd, "features")
    test_json = os.path.join(feat, "test_data.json")
    jutts = jax_manifest(test_json)
    gts = [np.asarray(jax_durations(u), np.int64) for u in jutts]
    got = torch_dur_quality.oracle_metrics(feat, load_manifest(test_json),
                                           gts)
    assert got == jax_dur.oracle_metrics(feat, jutts, gts)


def test_frame_truth_and_phone_avg_match_jax():
    """On a synthetic utterance's own truth, with a perturbed track
    standing in for the estimate."""
    from fcl_taco2_tpu_torch.audio.synthcorpus import synth_utterance
    rng = np.random.default_rng(7)
    _, segs, f0_true, vmask = synth_utterance(rng, 20, return_truth=True)
    T = 1 + len(f0_true) // 256
    got = torch_f0_groundtruth_eval.frame_truth(f0_true, vmask, T)
    want = jax_f0.frame_truth(f0_true, vmask, T)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    tf0, tv = want
    est = np.where(tv, tf0 * rng.uniform(0.97, 1.03, T), 0.0)
    for values, voiced in ((est, est > 0), (np.where(tv, tf0, 0.0), tv)):
        np.testing.assert_array_equal(
            torch_f0_groundtruth_eval.phone_avg(values, voiced, segs, T),
            jax_f0.phone_avg(values, voiced, segs, T))


def test_int8_codes_and_snr_match_jax():
    """``quantize_matrix`` (bf16-cast weights, the port's
    ``quantize_per_column``) against ``quant_quality.py:89-110``."""
    from fcl_taco2_tpu.ops.decoder_pallas import quantize_per_column
    w = np.random.default_rng(1).normal(0, 0.05, (256, 1024)).astype(
        np.float32)
    w[:, 3] = 0.0  # a dead column
    q, s, w_in, deq = torch_quant_quality.quantize_matrix(w, torch.bfloat16)
    jw = np.asarray(np.asarray(w, np.float32).astype(jnp.bfloat16),
                    np.float32)
    jq, js = quantize_per_column(jw)
    jdeq = np.asarray(jq, np.float32) * np.asarray(js)[None, :]
    np.testing.assert_array_equal(w_in, jw)
    np.testing.assert_array_equal(q, np.asarray(jq))
    np.testing.assert_array_equal(s, np.asarray(js))
    np.testing.assert_array_equal(deq, jdeq)
    err = jdeq - jw
    want = round(float(10 * np.log10(np.mean(jw ** 2)
                                     / max(np.mean(err ** 2), 1e-30))), 1)
    assert torch_quant_quality.snr_db(w_in, deq) == want


def test_other_quality_scripts_run_on_cpu(run):
    """The duration, int8, serving-distribution and F0 scripts on the
    run's workdir with ``--device cpu``: each JSON has its JAX record's
    keys."""
    root, wd, _ = run
    feat = os.path.join(wd, "features")
    teacher = os.path.join(wd, "exp_teacher", "model.loss.best")
    outs = {
        "DUR_quality.json": torch_dur_quality.main([
            "--device", "cpu", "--feat-dir", feat,
            "--teacher-exp", os.path.join(wd, "exp_teacher"),
            "--student-exp", os.path.join(wd, "exp_student"),
            "--out", str(root / "dur.json")]),
        "QUANT_decode.json": torch_quant_quality.main([
            "--device", "cpu", "--workdir", wd,
            "--out", str(root / "quant.json")]),
        "DECODE_protocol.json": torch_decode_protocol.main([
            "--device", "cpu", "--model", teacher,
            "--json", os.path.join(feat, "test_data.json"), "--parts", "3",
            "--workdir", str(root / "proto"),
            "--out", str(root / "decode.json")]),
        "F0_groundtruth.json": torch_f0_groundtruth_eval.main([
            "--device", "cpu", "--n-utts", "2",
            "--out", str(root / "f0.json")]),
    }
    for name, payload in outs.items():
        top, proto = _jax_keys(name)
        assert top <= set(payload), (name, top - set(payload))
        assert proto <= set(payload["protocol"]), name
        assert payload["protocol"]["device"]["device"] == "cpu"
    quant = outs["QUANT_decode.json"]
    assert set(quant["vs_ground_truth"]) == {
        f"{t}_{d}" for t in ("fp32", "int8", "int8_kernel")
        for d in ("pred_dur", "gt_dur")}
    assert set(quant["weight_snr_db"]) == {"lstm0.wh", "lstm1.wx",
                                           "lstm1.wh"}
    # the kernel row's codes reach the decode: it differs from the
    # checkpoint's own decode, by quantization noise only
    for d in ("pred_dur", "gt_dur"):
        assert 0 < quant["int8_kernel_vs_fp32_direct"][d]["l1"] < 0.05
    assert outs["DECODE_protocol.json"]["n_utts"] == 3
