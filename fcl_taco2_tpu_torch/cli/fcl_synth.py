#!/usr/bin/env python3
"""Decode a manifest to mel spectrograms (ark/scp + speed report); port of
``fcl_taco2_tpu/cli/fcl_synth.py`` with the same flags, plus ``--device``.

    python -m fcl_taco2_tpu_torch.cli.fcl_synth --model EXP/model.loss.best \
        --json data.json --out OUT [--device cpu]

Loads model.json + a checkpoint written by either package (a KD
snapshot's projections are ignored), decodes every utterance in --json in
batches, and writes feats.ark/feats.scp (parallel-wavegan-decode
compatible) and a frames/s summary (decode.txt).  Runs on the card
unless ``--device cpu`` is given, and raises when no card is present.
``--n-devices N`` (default 1) serves sharded over N ranks, one process a
card (``Synthesizer(mesh=...)``): each decodes its rows of every batch,
and rank 0 writes the files.
"""

import argparse
import os


def get_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", type=str, required=True,
                   help="checkpoint path (snapshot.ep.N / model.loss.best)")
    p.add_argument("--model-conf", type=str, default=None,
                   help="exp dir containing model.json (default: the "
                        "checkpoint's directory)")
    p.add_argument("--json", type=str, required=True)
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--frame-per-token", type=int, default=16,
                   help="output frame budget per input token when durations "
                        "are predicted (raise if truncation is reported)")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--d-factor", type=float, default=1.0,
                   help="duration multiplier (speaking-rate control)")
    p.add_argument("--use-gt-durations", action="store_true",
                   help="use corpus durations instead of the predictor "
                        "(reference dur= override)")
    p.add_argument("--no-ark", action="store_true")
    p.add_argument("--n-devices", type=int, default=1,
                   help="devices to serve on, one process a card; the "
                        "batch size must divide by them")
    p.add_argument("--no-ragged-decode", action="store_true",
                   help="disable the duration-sorted, duration-bounded AR "
                        "decode (every phoneme runs to the max_dur cap)")
    p.add_argument("--quantize", choices=("none", "int8"), default="none",
                   help="int8: the weight-streaming decoder kernel reads "
                        "its big matrices as per-column int8 codes")
    p.add_argument("--decoder-backend", default="auto",
                   choices=("auto", "scan", "pallas", "pallas_hbm",
                            "hybrid"),
                   help="AR decode backend (Tacotron2SA.decode_segments)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default: cuda, which must be "
                        "present; cpu runs the plain PyTorch versions)")
    return p


def load_acoustic_model(model_path, model_conf=None, device="cuda"):
    """model.json + a checkpoint -> a ``Tacotron2SA`` on ``device``."""
    from fcl_taco2_tpu_torch.models import Tacotron2SA
    from fcl_taco2_tpu_torch.train.checkpoint import (load_model_json,
                                                      load_params_only)

    cfg, _ = load_model_json(model_conf or os.path.dirname(model_path))
    return load_params_only(model_path, Tacotron2SA(cfg, device=device))


def main(argv=None):
    """Decode; returns the mean frames/s, or None when the ranks of
    ``--n-devices`` were spawned from here."""
    from fcl_taco2_tpu_torch.parallel.distributed import cli_ranks, run_ranks
    args = get_parser().parse_args(argv)
    return run_ranks(_synth_rank, cli_ranks(args.n_devices, args.device),
                     argv, args.device)


def _synth_rank(device, argv):
    """One rank's decode on ``device``: every rank decodes its rows of
    every batch, rank 0 writes the files and prints."""
    from fcl_taco2_tpu_torch.data import load_manifest
    from fcl_taco2_tpu_torch.infer import Synthesizer
    from fcl_taco2_tpu_torch.parallel.mesh import make_mesh

    args = get_parser().parse_args(argv)
    mesh = make_mesh(args.n_devices)
    model = load_acoustic_model(args.model, args.model_conf, device)
    utts = load_manifest(args.json)
    synth = Synthesizer(model, batch_size=args.batch_size,
                        frame_per_token=args.frame_per_token,
                        ragged_decode=not args.no_ragged_decode,
                        quantize=args.quantize,
                        decoder_backend=args.decoder_backend,
                        device=device, mesh=mesh)
    mean_fps = synth.synth_manifest(
        utts, args.out, write_ark=not args.no_ark, rng=args.seed,
        use_gt_durations=args.use_gt_durations, d_factor=args.d_factor)
    if mesh.rank == 0:
        print(f"decoded {len(utts)} utts, mean {mean_fps:.1f} frames/sec "
              f"-> {args.out}")
    return mean_fps


if __name__ == "__main__":
    main()
