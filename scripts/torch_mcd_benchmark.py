#!/usr/bin/env python3
"""End-to-end MCD of the PyTorch port (the port's copy of
``scripts/mcd_benchmark.py``): synthetic corpus -> ``fcl_preprocess`` ->
teacher trained to ``model.loss.best`` -> KD student -> decode of the
held-out test shard (predicted and ground-truth durations) ->
``fcl_eval`` MCD/L1/RMSE + frames/s, and the calibration floors.

The stages, arguments, defaults and calls are the JAX script's, through
the port's CLIs (``fcl_taco2_tpu_torch/cli``).  Differences: ``--device``
(default ``cuda``; no card raises unless ``--device cpu`` is given),
``--teacher-config`` / ``--student-config`` (the teacher trains with
``fcl_train``'s own defaults, which are FCL-taco2-T's, as in JAX; the
flags exist so a CPU test can run tiny widths), the default ``--out``,
and ``protocol.device`` (the card's name and power limit from nvidia-smi,
torch and CUDA versions) where JAX wrote its backend.  ``floors`` also
gives the predict-the-train-mean L1 beside JAX's two MCD floors.

    python3 scripts/torch_mcd_benchmark.py [--stage all|teacher|student]
        [--n-utts 480] [--epochs 80] [--workdir DIR] [--device cuda]
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

STUDENT_CONFIG = os.path.join(REPO, "conf", "train_fcl_taco2.student.yaml")
TEACHER_CONFIG = os.path.join(REPO, "conf", "train_fcl_taco2.teacher.yaml")


def require_device(device):
    """Raise unless ``device`` is present: no silent CPU fallback."""
    from fcl_taco2_tpu_torch.utils.device import resolve_device
    return resolve_device(device)


def device_info(device):
    """What ran the numbers: the card's name and power limit as nvidia-smi
    gives them, and the torch and CUDA versions."""
    import torch
    info = {"device": str(device), "torch": torch.__version__,
            "cuda": torch.version.cuda}
    if torch.device(device).type == "cuda":
        info["kind"] = torch.cuda.get_device_name(0)
        info["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    return info


def decode_and_eval(feat, out_dir, ckpt, device, extra_synth=()):
    """``fcl_synth`` over the test shard (batch 8, seed 1) then
    ``fcl_eval``: the summary with the decode's mean frames/s."""
    from fcl_taco2_tpu_torch.cli import fcl_eval, fcl_synth
    test_json = os.path.join(feat, "test_data.json")
    fcl_synth.main(["--model", ckpt, "--json", test_json, "--out", out_dir,
                    "--batch-size", "8", "--device", device, *extra_synth])
    with open(os.path.join(out_dir, "decode.txt")) as f:
        fps = next(float(ln.split()[1]) for ln in f
                   if ln.startswith("mean_frames_per_sec"))
    report_path = os.path.join(out_dir, "eval.json")
    fcl_eval.main(["--feats-scp", os.path.join(out_dir, "feats.scp"),
                   "--json", test_json, "--out", report_path])
    with open(report_path) as f:
        summary = json.load(f)["summary"]
    return dict(summary, frames_per_sec=fps)


def floors(feat):
    """Calibration floors on the test shard's denormalized log-mels: the
    MCD and L1 of predicting the train-mean frame, and the MCD of
    comparing mismatched utterances (``mcd_benchmark.py:141-160``).  The
    corpus has irreducible stochastic excitation, so absolute MCD is read
    against these."""
    import numpy as np
    from fcl_taco2_tpu_torch.data import load_manifest
    from fcl_taco2_tpu_torch.data.manifest import _load_feat
    from fcl_taco2_tpu_torch.infer.metrics import (mel_cepstral_distortion,
                                                   mel_l1)
    mean, std = np.load(os.path.join(feat, "mel_stats.npy"))
    test_utts = load_manifest(os.path.join(feat, "test_data.json"))
    mels = [_load_feat(u.mel_path, u.filetypes[0]) * std + mean
            for u in test_utts]
    return {
        "predict_mean_mcd": float(np.mean([
            mel_cepstral_distortion(np.broadcast_to(mean, m.shape), m)
            for m in mels])),
        "mismatched_utterance_mcd": float(np.mean([
            mel_cepstral_distortion(mels[(i + 1) % len(mels)], m)
            for i, m in enumerate(mels)])),
        "predict_mean_l1": float(np.mean([
            mel_l1(np.broadcast_to(mean, m.shape), m) for m in mels])),
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workdir", type=str, default=os.path.join(
        tempfile.gettempdir(), "fcl_torch_mcd_run"))
    p.add_argument("--n-utts", type=int, default=480)
    p.add_argument("--n-val", type=int, default=40)
    p.add_argument("--n-test", type=int, default=40)
    p.add_argument("--epochs", type=int, default=80)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--seed", type=int, default=137)  # reference seed
    p.add_argument("--out", type=str, default=os.path.join(
        REPO, "results", "TORCH_MCD_e2e.json"))
    p.add_argument("--corpus-seed", type=int, default=7)
    p.add_argument("--stage", choices=["all", "teacher", "student"],
                   default="all",
                   help="'student' reuses an existing teacher run in "
                        "--workdir (KD + decode + eval only)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default: the card; cpu must be "
                        "asked for)")
    p.add_argument("--teacher-config", type=str, default=None,
                   help="fcl_train config of the teacher (default: "
                        "fcl_train's own defaults, FCL-taco2-T)")
    p.add_argument("--student-config", type=str, default=STUDENT_CONFIG)
    args = p.parse_args(argv)
    require_device(args.device)

    from fcl_taco2_tpu_torch.audio.synthcorpus import generate_corpus
    from fcl_taco2_tpu_torch.cli import fcl_preprocess, fcl_train

    wd = args.workdir
    corpus = os.path.join(wd, "corpus")
    feat = os.path.join(wd, "features")
    exp = os.path.join(wd, "exp_teacher")
    exp_s = os.path.join(wd, "exp_student")
    t_start = time.time()
    results = {}
    train_sec = kd_sec = None
    teacher_conf = (["--config", args.teacher_config]
                    if args.teacher_config else [])
    common = ["--train-json", os.path.join(feat, "train_data.json"),
              "--valid-json", os.path.join(feat, "val_data.json"),
              "--epochs", str(args.epochs),
              "--batch-size", str(args.batch_size),
              "--seed", str(args.seed), "--n-devices", "1",
              "--device", args.device]

    def decode(ckpt, tag, extra_synth=()):
        print(f"[eval] {tag} ...", flush=True)
        results[tag] = decode_and_eval(
            feat, os.path.join(wd, f"decode_{tag}"), ckpt, args.device,
            extra_synth)

    if args.stage in ("all", "teacher"):
        if os.path.exists(os.path.join(feat, "train_data.json")):
            print("[1-2/5] reusing existing corpus + features in "
                  f"{feat}", flush=True)
        else:
            print(f"[1/5] generating {args.n_utts}-utterance corpus ...",
                  flush=True)
            generate_corpus(corpus, n_utts=args.n_utts,
                            seed=args.corpus_seed, log=print)
            print("[2/5] preprocessing (mel/f0/energy, normalize, split) "
                  "...", flush=True)
            fcl_preprocess.main([
                "--data-root", corpus, "--feature-root", feat,
                "--textgrid-root", os.path.join(corpus, "tg"),
                "--n-val", str(args.n_val), "--n-test", str(args.n_test),
                "--seed", "1", "--device", args.device])

        print(f"[3/5] training the teacher for {args.epochs} epochs ...",
              flush=True)
        t0 = time.time()
        fcl_train.main([*teacher_conf, *common, "--outdir", exp,
                        "--perform-KD", "False"])
        train_sec = time.time() - t0

        print("[4/5] decoding + evaluating the test shard ...", flush=True)
        ckpt = os.path.join(exp, "model.loss.best")
        decode(ckpt, "pred_dur")
        decode(ckpt, "gt_dur", ["--use-gt-durations"])

    if args.stage in ("all", "student"):
        # the reference's workflow part 2: distil FCL-taco2-S from the
        # frozen teacher (student_model_training.sh), then its own MCD
        print(f"[KD] distilling the student for {args.epochs} epochs ...",
              flush=True)
        t0 = time.time()
        fcl_train.main([
            "--config", args.student_config, *common, "--outdir", exp_s,
            "--perform-KD", "True", "--share-proj", "True",
            "--teacher-config", args.teacher_config or TEACHER_CONFIG,
            "--teacher-checkpoint", os.path.join(exp, "model.loss.best")])
        kd_sec = time.time() - t0
        ckpt_s = os.path.join(exp_s, "model.loss.best")
        decode(ckpt_s, "student_pred_dur")
        decode(ckpt_s, "student_gt_dur", ["--use-gt-durations"])

    payload = {
        "protocol": {
            "corpus": "formant-synthesized speech-like corpus "
                      "(fcl_taco2_tpu_torch/audio/synthcorpus.py), "
                      "LJSpeech unavailable offline",
            "n_utts": args.n_utts, "n_val": args.n_val,
            "n_test": args.n_test, "epochs": args.epochs,
            "batch_size": args.batch_size,
            "model": "FCL-taco2-T (512-d teacher) -> KD FCL-taco2-S "
                     "(256-d student), bf16 compute",
            "teacher_config": args.teacher_config or "fcl_train defaults",
            "student_config": os.path.relpath(args.student_config, REPO),
            "checkpoint": "model.loss.best",
            "features": "80 mel / 1024 fft / 256 hop / 22.05 kHz",
            "mcd": "dB over DENORMALIZED log-mels (fcl_eval auto-applies "
                   "mel_stats.npy), DCT-II cepstra c1..c13, trim-to-min "
                   "alignment",
            "device": device_info(args.device),
        },
        "teacher_train_wall_sec": train_sec and round(train_sec, 1),
        "kd_train_wall_sec": kd_sec and round(kd_sec, 1),
        "total_wall_sec": round(time.time() - t_start, 1),
        "floors": floors(feat),
        "results": results,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    if os.path.exists(args.out):  # staged runs merge into one file
        with open(args.out) as f:
            old = json.load(f)
        payload["results"] = {**old.get("results", {}), **results}
        for k in ("teacher_train_wall_sec", "kd_train_wall_sec"):
            payload[k] = payload[k] or old.get(k)
        if "notes" in old:
            payload["notes"] = old["notes"]
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=2)
    print(json.dumps(payload["results"], indent=2))
    print(f"wrote {args.out}")
    return payload


if __name__ == "__main__":
    main()
