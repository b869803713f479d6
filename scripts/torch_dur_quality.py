#!/usr/bin/env python3
"""Duration-predictor quality of the PyTorch port (the port's copy of
``scripts/dur_quality.py``).

Measures, on the held-out test shard:
1. predicted-duration accuracy for teacher and student: per-phone L1 /
   RMSE / Pearson correlation and per-utterance total-length relative
   error;
2. a train-split oracle: the per-token conditional mean, the best any
   model can do from token identity alone on this corpus;
3. the student's MCD under (a) its own predicted durations, (b) the
   teacher's, (c) ground truth, decoded through
   ``infer/synth.py::Synthesizer`` (the student's decode is
   ``fused_ar_decode`` on the card).

Inference rounds ``round(exp(logd) - 1)`` clamped to ``[0, max_dur]``,
as the JAX package and espnet's DurationPredictor (offset 1).

    python3 scripts/torch_dur_quality.py --feat-dir WD/features \
        --teacher-exp WD/exp_teacher [--student-exp WD/exp_student] \
        [--device cuda] [--out results/TORCH_DUR_quality.json]
"""

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def predict_durations(model, utts, batch=16):
    """``synth_frontend`` of the compute-dtype model over padded batches ->
    (per-utterance predicted durations, ground-truth durations), int64 at
    true length."""
    import torch

    from fcl_taco2_tpu_torch.data.manifest import load_durations

    model = model.compute_model()
    dev = next(model.parameters()).device
    Tmax = int(np.ceil(max(u.n_tokens for u in utts) / 8) * 8)
    preds, gts = [], []
    for i in range(0, len(utts), batch):
        chunk = utts[i:i + batch]
        toks = np.zeros((batch, Tmax), np.int64)
        ilens = np.zeros(batch, np.int64)
        for j, u in enumerate(chunk):
            t = np.asarray(u.tokenids, np.int64)
            toks[j, :len(t)] = t
            ilens[j] = len(t)
        with torch.no_grad():
            _, d, _, _ = model.synth_frontend(
                torch.from_numpy(toks).to(dev),
                torch.from_numpy(ilens).to(dev))
        d = d.cpu().numpy()
        for j, u in enumerate(chunk):
            preds.append(d[j, :ilens[j]].astype(np.int64))
            gts.append(np.asarray(load_durations(u), np.int64))
    return preds, gts


def duration_metrics(preds, gts):
    p = np.concatenate(preds).astype(np.float64)
    g = np.concatenate(gts).astype(np.float64)
    tot_rel = np.asarray([abs(a.sum() - b.sum()) / max(b.sum(), 1)
                          for a, b in zip(preds, gts)])
    corr = float(np.corrcoef(p, g)[0, 1]) if len(p) > 1 else float("nan")
    return {
        "n_phones": int(len(p)),
        "gt_mean_frames": round(float(g.mean()), 3),
        "pred_mean_frames": round(float(p.mean()), 3),
        "l1_frames": round(float(np.abs(p - g).mean()), 4),
        "rmse_frames": round(float(np.sqrt(((p - g) ** 2).mean())), 4),
        "pearson_r": round(corr, 4),
        "utt_total_len_rel_err_mean": round(float(tot_rel.mean()), 4),
        "utt_total_len_rel_err_p90": round(
            float(np.percentile(tot_rel, 90)), 4),
    }


def oracle_metrics(feat_dir, test_utts, gts):
    """Train-split per-token conditional-mean predictor: the learnable
    floor given token identity."""
    from fcl_taco2_tpu_torch.data import load_manifest
    from fcl_taco2_tpu_torch.data.manifest import load_durations

    train = load_manifest(os.path.join(feat_dir, "train_data.json"))
    toks = np.concatenate([np.asarray(u.tokenids, np.int64)
                           for u in train])
    durs = np.concatenate([np.asarray(load_durations(u), np.int64)
                           for u in train])
    means = {int(t): durs[toks == t].mean() for t in np.unique(toks)}
    gmean = durs.mean()
    preds = [np.asarray([means.get(int(t), gmean) for t in u.tokenids])
             for u in test_utts]
    out = duration_metrics(preds, gts)
    out["what"] = ("train-split per-token conditional mean (learnable "
                   "floor; fractional frames, no rounding)")
    return out


def mcd_with_durations(model, utts, mel_stats, durations, batch=8, seed=1,
                       device="cuda"):
    """Synthesize with explicit per-utterance durations (or None for the
    model's own predictor) and score MCD/L1 against ground-truth mels."""
    from fcl_taco2_tpu_torch.data.manifest import _load_feat
    from fcl_taco2_tpu_torch.infer.metrics import mel_cepstral_distortion
    from fcl_taco2_tpu_torch.infer.synth import Synthesizer

    mean, std = mel_stats
    synth = Synthesizer(model, batch_size=batch, frame_per_token=16,
                        device=device)
    mcds, l1s = [], []
    for i in range(0, len(utts), batch):
        chunk = utts[i:i + batch]
        toks = [np.asarray(u.tokenids, np.int32) for u in chunk]
        durs = None if durations is None else [
            np.asarray(durations[i + j], np.int32)
            for j in range(len(chunk))]
        mels, _ = synth.synth_batch(toks, seed + i, durations=durs)
        for u, m in zip(chunk, mels):
            gt = _load_feat(u.mel_path, u.filetypes[0]) * std + mean
            m = m * std + mean
            n = min(len(gt), len(m))
            mcds.append(mel_cepstral_distortion(m[:n], gt[:n]))
            l1s.append(float(np.abs(m[:n] - gt[:n]).mean()))
    return {"mcd": round(float(np.mean(mcds)), 3),
            "l1": round(float(np.mean(l1s)), 4), "n_utts": len(mcds)}


def load_model(exp_dir, ckpt=None, device="cuda"):
    """model.json + ``model.loss.best`` (or ``ckpt``) -> a ``Tacotron2SA``
    on ``device``."""
    from fcl_taco2_tpu_torch.cli.fcl_synth import load_acoustic_model
    return load_acoustic_model(
        ckpt or os.path.join(exp_dir, "model.loss.best"), exp_dir, device)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--feat-dir", type=str, required=True)
    p.add_argument("--teacher-exp", type=str, required=True)
    p.add_argument("--student-exp", type=str, default=None)
    p.add_argument("--json", type=str, default=None,
                   help="default: <feat-dir>/test_data.json")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--out", type=str, default=os.path.join(
        REPO, "results", "TORCH_DUR_quality.json"))
    args = p.parse_args(argv)

    from torch_mcd_benchmark import device_info, require_device
    require_device(args.device)
    from fcl_taco2_tpu_torch.data import load_manifest

    utts = load_manifest(args.json
                         or os.path.join(args.feat_dir, "test_data.json"))
    mel_stats = np.load(os.path.join(args.feat_dir, "mel_stats.npy"))
    payload = {"protocol": {
        "what": "held-out duration accuracy (per-phone L1/RMSE/Pearson, "
                "per-utt total-length rel err) + pred-dur MCD sensitivity "
                "(student decoded with own/teacher/gt durations)",
        "n_utts": len(utts), "device": device_info(args.device),
        "rounding": "round(exp(logd)-1) clamp [0,max_dur] == espnet "
                    "DurationPredictor.inference offset=1",
    }}

    t_model = load_model(args.teacher_exp, device=args.device)
    t_preds, gts = predict_durations(t_model, utts)
    payload["teacher_durations"] = duration_metrics(t_preds, gts)
    print("teacher durations:",
          json.dumps(payload["teacher_durations"]), flush=True)
    payload["oracle_durations"] = oracle_metrics(args.feat_dir, utts, gts)
    print("oracle (train-split per-token mean):",
          json.dumps(payload["oracle_durations"]), flush=True)

    if args.student_exp:
        s_model = load_model(args.student_exp, device=args.device)
        s_preds, _ = predict_durations(s_model, utts)
        payload["student_durations"] = duration_metrics(s_preds, gts)
        print("student durations:",
              json.dumps(payload["student_durations"]), flush=True)
        sens = {}
        for tag, durs in (("own_pred", None), ("teacher_pred", t_preds),
                          ("gt", gts)):
            sens[tag] = mcd_with_durations(s_model, utts, mel_stats, durs,
                                           device=args.device)
            print(f"student MCD [{tag}]:", json.dumps(sens[tag]),
                  flush=True)
        payload["student_mcd_by_duration_source"] = sens

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=2)
    print(f"wrote {args.out}")
    return payload


if __name__ == "__main__":
    main()
