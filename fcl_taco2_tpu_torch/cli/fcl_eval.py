#!/usr/bin/env python3
"""Evaluate decoded mels (feats.scp) against ground-truth mels (manifest);
port of ``fcl_taco2_tpu/cli/fcl_eval.py`` with the same flags and output.

    python -m fcl_taco2_tpu_torch.cli.fcl_eval --feats-scp OUT/feats.scp \
        --json data.json [--out report.json]

Computes MCD / L1 / RMSE between synthesized and reference log-mels (the
objective half of the reference's external MOS/MCD evaluation) and prints
a one-line JSON summary.  Host-only (numpy + scipy): no device is used.
"""

import argparse
import json
import os

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--feats-scp", type=str, required=True)
    p.add_argument("--json", type=str, required=True,
                   help="manifest with ground-truth mel paths")
    p.add_argument("--out", type=str, default=None,
                   help="optional json report path")
    p.add_argument("--mel-stats", type=str, default=None,
                   help="mel_stats.npy (mean/std rows) to DENORMALIZE both "
                        "sides so MCD is in standard log-mel dB; default: "
                        "auto-discover next to --json; pass 'none' to "
                        "compare normalized features as-is")
    args = p.parse_args(argv)

    from fcl_taco2_tpu_torch.data import load_manifest
    from fcl_taco2_tpu_torch.data.manifest import _load_feat
    from fcl_taco2_tpu_torch.infer.ark import read_ark_matrix
    from fcl_taco2_tpu_torch.infer.metrics import (mel_cepstral_distortion,
                                                   mel_l1, mel_rmse)

    # manifests store mean/var-normalized mels; MCD in the literature is
    # over raw log-mels, so denormalize with the training stats when found
    stats = args.mel_stats
    if stats is None:
        cand = os.path.join(os.path.dirname(os.path.abspath(args.json)),
                            "mel_stats.npy")
        stats = cand if os.path.exists(cand) else "none"
    if stats != "none":
        mean, std = np.load(stats)
        denorm = lambda m: m * std + mean  # noqa: E731
    else:
        denorm = lambda m: m  # noqa: E731

    utts = {u.uttid: u for u in load_manifest(args.json)}
    rows = []
    with open(args.feats_scp) as f:
        for line in f.read().splitlines():
            uttid, pointer = line.split()
            if uttid not in utts:
                continue
            hyp = denorm(read_ark_matrix(pointer))
            u = utts[uttid]
            ref = denorm(_load_feat(u.mel_path, u.filetypes[0]))
            rows.append({
                "uttid": uttid,
                "mcd": mel_cepstral_distortion(hyp, ref),
                "l1": mel_l1(hyp, ref),
                "rmse": mel_rmse(hyp, ref),
                "len_hyp": len(hyp), "len_ref": len(ref),
            })
    if not rows:
        raise SystemExit("no overlapping utterances between scp and json")
    summary = {k: float(np.mean([r[k] for r in rows]))
               for k in ("mcd", "l1", "rmse")}
    summary["n_utts"] = len(rows)
    summary["units"] = ("log-mel dB (denormalized)" if stats != "none"
                        else "normalized feature units")
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "utts": rows}, f, indent=2)
    return summary


if __name__ == "__main__":
    main()
