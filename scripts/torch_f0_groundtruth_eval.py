#!/usr/bin/env python3
"""The port's YIN F0 extractor against the synthetic corpus's own
excitation truth (the port's copy of ``scripts/f0_groundtruth_eval.py``).

The corpus generator (``audio/synthcorpus.py``) synthesizes voiced
phones as harmonics of a known per-sample F0 track, so this scores the
tracker on speech-like signals with exact truth:

1. frame level: ``ops/f0.py::yin_f0`` (on the card by default) at the
   preprocessing parameters (hop 256, win 1024, threshold 0.35) vs the
   generator's per-sample track and voicing mask sampled at frame
   centers -> voicing P/R/F1, cents error, gross and octave error rates;
2. phone level: the phoneme-averaged voiced-only log-F0 that
   preprocessing emits vs the same averaging of the true track.

    python3 scripts/torch_f0_groundtruth_eval.py [--n-utts 24] \
        [--device cuda] [--out results/TORCH_F0_groundtruth.json]
"""

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

SR = 22050
HOP = 256


def frame_truth(f0_track, voiced_mask, n_frames):
    """Sample the per-sample truth at STFT frame centers (center=True grid:
    frame t covers [t*hop - win/2, t*hop + win/2); voicing truth is the
    majority vote over the hop around the center)."""
    n = len(f0_track)
    centers = np.minimum(np.arange(n_frames) * HOP, n - 1)
    tf0 = f0_track[centers]
    half = HOP // 2
    tv = np.zeros(n_frames, bool)
    for t, c in enumerate(centers):
        a, b = max(c - half, 0), min(c + half, n)
        tv[t] = voiced_mask[a:b].mean() > 0.5 if b > a else False
    return tf0, tv


def phone_avg(values, voiced, segs, n_frames):
    """Voiced-only per-phone mean of log-F0 (the preprocessing semantic:
    average the nonzero frames inside each phone span, 0 if none)."""
    out = []
    for (a_s, b_s, phone) in segs:
        a, b = int(a_s * SR) // HOP, min(int(b_s * SR) // HOP, n_frames)
        if b <= a:
            out.append(0.0)
            continue
        sel = voiced[a:b] & (values[a:b] > 0)
        out.append(float(np.log(values[a:b][sel]).mean()) if sel.any()
                   else 0.0)
    return np.asarray(out)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n-utts", type=int, default=24)
    p.add_argument("--seed", type=int, default=7)  # the MCD corpus seed
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--out", type=str, default=os.path.join(
        REPO, "results", "TORCH_F0_groundtruth.json"))
    args = p.parse_args(argv)

    from torch_mcd_benchmark import device_info, require_device
    require_device(args.device)
    from fcl_taco2_tpu_torch.audio.synthcorpus import synth_utterance
    from fcl_taco2_tpu_torch.ops.f0 import yin_f0

    rng = np.random.default_rng(args.seed)
    cents_all, tv_all, pv_all = [], [], []
    gross = octave = both_voiced = 0
    phone_lf0_err, phone_voicing_match = [], []
    for i in range(args.n_utts):
        n_ph = int(rng.integers(14, 41))
        wav, segs, f0_true, vmask = synth_utterance(rng, n_ph,
                                                    return_truth=True)
        est = yin_f0(np.asarray(wav, np.float32), SR, HOP,
                     device=args.device).cpu().numpy()
        T = len(est)
        tf0, tv = frame_truth(f0_true, vmask, T)
        pv = est > 0
        tv_all.append(tv)
        pv_all.append(pv)
        m = tv & pv
        both_voiced += int(m.sum())
        if m.any():
            cents = 1200.0 * np.log2(est[m] / tf0[m])
            cents_all.append(cents)
            gross += int((np.abs(cents) > 200).sum())
            octave += int((np.abs(np.abs(cents) - 1200) < 100).sum())
        est_avg = phone_avg(est, pv, segs, T)
        true_avg = phone_avg(np.where(tv, tf0, 0.0), tv, segs, T)
        both = (est_avg != 0) & (true_avg != 0)
        phone_voicing_match.append((est_avg != 0) == (true_avg != 0))
        if both.any():
            phone_lf0_err.append(np.abs(est_avg[both] - true_avg[both]))

    tv = np.concatenate(tv_all)
    pv = np.concatenate(pv_all)
    cents = np.concatenate(cents_all) if cents_all else np.zeros(0)
    tp = int((tv & pv).sum())
    prec = tp / max(int(pv.sum()), 1)
    rec = tp / max(int(tv.sum()), 1)
    f1 = 2 * prec * rec / max(prec + rec, 1e-9)
    ph_match = np.concatenate(phone_voicing_match)
    ph_err = np.concatenate(phone_lf0_err) if phone_lf0_err else np.zeros(0)

    payload = {
        "protocol": {
            "what": "YIN (preprocessing params: hop 256, win 1024, "
                    "threshold 0.35) vs the synthcorpus generator's "
                    "per-sample excitation F0 + voicing mask; frame truth "
                    "sampled at frame centers, voicing by majority over "
                    "the hop; phone level = voiced-only lf0 phoneme "
                    "averaging on both sides",
            "n_utts": args.n_utts, "seed": args.seed,
            "n_frames": int(len(tv)), "n_phones": int(len(ph_match)),
            "device": device_info(args.device),
        },
        "frame_level": {
            "voicing_precision": round(prec, 4),
            "voicing_recall": round(rec, 4),
            "voicing_f1": round(f1, 4),
            "median_abs_cents": round(float(np.median(np.abs(cents))), 2),
            "p90_abs_cents": round(float(np.percentile(np.abs(cents), 90)),
                                   2),
            "gross_error_rate_gt200c": round(gross / max(both_voiced, 1),
                                             5),
            "octave_error_rate": round(octave / max(both_voiced, 1), 6),
        },
        "phone_level": {
            "voicing_decision_match": round(float(ph_match.mean()), 4),
            "median_abs_lf0_err": round(float(np.median(ph_err)), 4),
            "p90_abs_lf0_err": round(float(np.percentile(ph_err, 90)), 4),
            "note": "lf0 err in log-Hz; 0.01 ~= 17 cents",
        },
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=2)
    print(json.dumps(payload, indent=2))
    print(f"wrote {args.out}")
    return payload


if __name__ == "__main__":
    main()
