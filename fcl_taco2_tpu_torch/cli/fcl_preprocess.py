#!/usr/bin/env python3
"""Preprocess LJSpeech-style corpora: wavs + MFA TextGrids -> features
and manifests; port of ``fcl_taco2_tpu/cli/fcl_preprocess.py`` with the
same flags (the reference's preprocess.py:244-260), plus ``--device``.

    python -m fcl_taco2_tpu_torch.cli.fcl_preprocess --data-root CORPUS \
        --textgrid-root CORPUS/tg --feature-root FEATS [--device cpu]

Log-mel, energy and YIN F0 run on the card, one batched call per length
bucket (``audio/preprocess.py::Frontend``), unless ``--device cpu`` is
given; without a card the default raises.
"""

import argparse

from fcl_taco2_tpu_torch.audio.preprocess import (PreprocessConfig,
                                                  run_preprocess)


def get_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-root", type=str, default="/Dataset/LJSpeech-1.1")
    p.add_argument("--feature-root", type=str, default="data")
    p.add_argument("--textgrid-root", type=str, default="TextGrid")
    p.add_argument("--set-fs", type=int, default=22050)
    p.add_argument("--fmax", type=int, default=7600)
    p.add_argument("--fmin", type=int, default=80)
    p.add_argument("--n-mels", type=int, default=80)
    p.add_argument("--n-fft", type=int, default=1024)
    p.add_argument("--n-shifts", type=int, default=256)
    p.add_argument("--win-length", type=int, default=0)
    p.add_argument("--max-dur", type=int, default=50)
    p.add_argument("--n-val", type=int, default=500)
    p.add_argument("--n-test", type=int, default=500)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the frontend (default: cuda, which "
                        "must be present; cpu runs it on the host)")
    return p


def main(argv=None, log=print):
    """Returns ``run_preprocess``'s (splits, stats); ``log`` receives its
    progress lines (each stage's seconds among them)."""
    args = get_parser().parse_args(argv)
    cfg = PreprocessConfig(
        data_root=args.data_root, feature_root=args.feature_root,
        textgrid_root=args.textgrid_root, set_fs=args.set_fs,
        fmax=args.fmax, fmin=args.fmin, n_mels=args.n_mels,
        n_fft=args.n_fft, n_shift=args.n_shifts,
        win_length=args.win_length, max_dur=args.max_dur,
        n_val=args.n_val, n_test=args.n_test, seed=args.seed,
        device=args.device)
    return run_preprocess(cfg, log=log)


if __name__ == "__main__":
    main()
