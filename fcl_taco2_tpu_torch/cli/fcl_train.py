#!/usr/bin/env python3
"""Train FCL-taco2 with the PyTorch port (port of
``fcl_taco2_tpu/cli/fcl_train.py``: the same flags and defaults, plus
``--device``).

    python -m fcl_taco2_tpu_torch.cli.fcl_train --train-json ... \
        --valid-json ... [--device cpu]

CLI mirror of the reference's tts_train.py (same flag names and yaml
config chain).  Training runs on the card unless ``--device cpu`` is given;
it raises when no card is present.  ``--perform-KD True`` distils a
student from ``--teacher-checkpoint`` (``cli/fcl_distill.py``).  The
defaults run the JAX trainer's single-card runtime: the dataset cache on
the device when it fits (``--device-cache auto``) and 4 steps a dispatch
with it (``--steps-per-dispatch 0``), on the card as replays of a CUDA
graph of the step.  Fine-tuning (``--enc-init``/``--dec-init``,
``--freeze-mods``), ``--preprocess-conf`` and ``--profile-dir`` work as
in the JAX CLI.  ``--n-devices N`` trains data-parallel on N cards, one
process a card (``parallel/``; by default every visible card, so a
one-card host runs one process), with the same losses as one card;
``--n-slices S`` groups them as S hosts of N/S (sums within a host,
then across hosts).  Under ``torchrun`` each process is the rank its
environment names.  --zoneout-rng is accepted and has no effect: the
port draws its masks from torch's Philox generator.
"""

import argparse
import os
import sys

from fcl_taco2_tpu_torch.utils.cliconf import parse_with_configs, strtobool


def get_parser():
    p = argparse.ArgumentParser(description=__doc__)
    # general
    p.add_argument("--outdir", type=str, default="exp/run")
    p.add_argument("--train-json", type=str, required=True)
    p.add_argument("--valid-json", type=str, required=True)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on (default: cuda, which "
                        "raises when no card is present; 'cpu' runs the "
                        "plain path)")
    p.add_argument("--n-devices", type=int, default=None,
                   help="data-parallel devices, one process a card "
                        "(default: every visible card; --device cpu: 1, "
                        "more run as CPU ranks over gloo)")
    p.add_argument("--n-slices", type=int, default=1,
                   help=">1: the devices as this many hosts (replica x "
                        "data grouping: gradients summed within a host, "
                        "then across hosts)")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--minibatches", type=int, default=0)
    p.add_argument("--verbose", type=int, default=0)
    p.add_argument("--debugmode", type=int, default=1,
                   help="reference-compat knob (tts_train.py:59); >=2 "
                        "enables autograd anomaly detection (fail at the "
                        "op that produced a NaN instead of the step-level "
                        "guard)")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="write a torch.profiler Chrome trace of the first "
                        "epoch (CPU and CUDA activity) into this "
                        "directory")
    # model (names match e2e_tts_tacotron2_sa.py:138-287)
    p.add_argument("--embed-dim", type=int, default=512)
    p.add_argument("--elayers", type=int, default=1)
    p.add_argument("--eunits", "-u", type=int, default=512)
    p.add_argument("--econv-layers", type=int, default=3)
    p.add_argument("--econv-chans", type=int, default=512)
    p.add_argument("--econv-filts", type=int, default=5)
    p.add_argument("--dlayers", type=int, default=2)
    p.add_argument("--dunits", type=int, default=1024)
    p.add_argument("--prenet-layers", type=int, default=2)
    p.add_argument("--prenet-units", type=int, default=256)
    p.add_argument("--postnet-layers", type=int, default=5)
    p.add_argument("--postnet-chans", type=int, default=512)
    p.add_argument("--postnet-filts", type=int, default=5)
    p.add_argument("--use-batch-norm", type=strtobool, default=True)
    p.add_argument("--use-concate", type=strtobool, default=True)
    p.add_argument("--use-residual", type=strtobool, default=False)
    p.add_argument("--use-masking", type=strtobool, default=True)
    p.add_argument("--use-weighted-masking", type=strtobool, default=False,
                   help="weight each utterance equally in the masked "
                        "losses (reference semantics) instead of the "
                        "default frame-weighted masked mean")
    p.add_argument("--spk-embed-dim", type=int, default=None,
                   help="speaker-embedding dim (None/0 = single speaker)")
    p.add_argument("--dropout-rate", type=float, default=0.5)
    p.add_argument("--zoneout-rate", type=float, default=0.1)
    p.add_argument("--duration-classes", type=str, default="8,16,32",
                   help="comma-separated ascending duration-class caps for "
                        "the classed training decoder (max-dur appended "
                        "implicitly); '' = single-class legacy shapes. "
                        "Training-only knob; losses are exactly equal "
                        "either way")
    p.add_argument("--decoder-scan-unroll", type=int, default=1,
                   help="accepted for compatibility; no effect (the "
                        "port's decoder loop is a Python loop)")
    p.add_argument("--zoneout-rng", type=str, default="rbg",
                   choices=("rbg", "threefry"),
                   help="accepted for compatibility; no effect (the port "
                        "draws zoneout masks from torch's Philox "
                        "generator)")
    p.add_argument("--reduction-factor", type=int, default=1)
    p.add_argument("--duration-predictor-layers", type=int, default=2)
    p.add_argument("--duration-predictor-chans", type=int, default=384)
    p.add_argument("--duration-predictor-kernel-size", type=int, default=3)
    p.add_argument("--duration-predictor-dropout-rate", type=float,
                   default=0.1)
    p.add_argument("--use-fe-condition", type=strtobool, default=True)
    p.add_argument("--append-position", type=strtobool, default=True)
    p.add_argument("--max-dur", type=int, default=50)
    p.add_argument("--compute-dtype", type=str, default="bfloat16")
    p.add_argument("--remat-decoder", type=strtobool, default=None,
                   help="recompute decoder scan activations on backward "
                        "(default: on for --perform-KD runs, else off)")
    p.add_argument("--model-module", type=str, default=None,
                   help="accepted for reference-config compatibility")
    p.add_argument("--use-second-target", type=strtobool, default=True)
    p.add_argument("--pad-eos", type=strtobool, default=False,
                   help="append eos (=vocab_size-1) to each token sequence "
                        "(io_utils_fcl.py:325-326)")
    p.add_argument("--preprocess-conf", type=str, default=None,
                   help="feature-transform conf applied by the loader "
                        "(espnet Transformation schema; tts_train.py:190, "
                        "io_utils_fcl.py:58-66)")
    # finetuning (tts_train.py:258-287): partial init + freezing; mods
    # are comma-separated pytree path prefixes, reference "enc."/"dec."
    # aliases accepted (train/finetune.py)
    comma_list = lambda s: tuple(m for m in s.split(",") if m)  # noqa: E731
    p.add_argument("--enc-init", type=str, default=None,
                   help="pre-trained checkpoint to initialize the encoder")
    p.add_argument("--enc-init-mods", type=comma_list, default=("enc.",))
    p.add_argument("--dec-init", type=str, default=None,
                   help="pre-trained checkpoint to initialize the decoder")
    p.add_argument("--dec-init-mods", type=comma_list, default=("dec.",))
    p.add_argument("--freeze-mods", type=comma_list, default=(),
                   help="modules to freeze (exclude from the optimizer), "
                        "comma-separated (tts.py:380-393)")
    # batching (tts_train.py:118-182)
    p.add_argument("--batch-size", "-b", type=int, default=16)
    p.add_argument("--batch-sort-key", type=str, default="shuffle",
                   choices=["shuffle", "input", "output"])
    p.add_argument("--maxlen-in", type=int, default=150)
    p.add_argument("--maxlen-out", type=int, default=400)
    p.add_argument("--batch-bins", type=int, default=0)
    p.add_argument("--batch-frames-in", type=int, default=0)
    p.add_argument("--batch-frames-out", type=int, default=0)
    p.add_argument("--batch-frames-inout", type=int, default=0)
    p.add_argument("--sortagrad", type=int, default=0)
    # loop knobs of the JAX package (no reference analogue)
    p.add_argument("--steps-per-dispatch", type=int, default=0,
                   help="optimizer steps per dispatch (replays of one "
                        "CUDA graph of the step on the card); 0 = auto: "
                        "4 with the device cache, else 1")
    p.add_argument("--ckpt-opt-dtype", type=str, default=None,
                   help="fetch optimizer moments in this dtype when "
                        "checkpointing (e.g. bfloat16: ~halves snapshot "
                        "bytes; restore upcasts)")
    p.add_argument("--device-cache", type=str, default="auto",
                   choices=["auto", "on", "off"],
                   help="device-resident dataset cache: auto builds it "
                        "when the corpus fits --device-cache-max-mb (else "
                        "says why it streams), on raises where it cannot "
                        "be built, off streams batches from the host")
    p.add_argument("--device-cache-max-mb", type=int, default=2048)
    # optimization (tts_train.py:205-247)
    p.add_argument("--opt", type=str, default="adam",
                   choices=["adam", "noam", "lamb"])
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--eps", type=float, default=1e-6)
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--grad-clip", type=float, default=1.0)
    p.add_argument("--accum-grad", type=int, default=1)
    p.add_argument("--epochs", "-e", type=int, default=100)
    p.add_argument("--patience", type=int, default=0)
    p.add_argument("--eval-interval-epochs", type=int, default=1)
    p.add_argument("--save-interval-epochs", type=int, default=1)
    # knowledge distillation (tts_train.py --perform-KD,
    # teacher_parser.py defaults)
    p.add_argument("--perform-KD", dest="perform_kd", type=strtobool,
                   default=False)
    p.add_argument("--teacher-config", type=str,
                   default="conf/train_fcl_taco2.teacher.yaml")
    p.add_argument("--teacher-checkpoint", type=str, default=None)
    p.add_argument("--share-proj", type=strtobool, default=True)
    p.add_argument("--distill-output-knowledge", type=strtobool,
                   default=True)
    p.add_argument("--distill-encoder-knowledge", type=strtobool,
                   default=True)
    p.add_argument("--distill-decoder-knowledge", type=strtobool,
                   default=True)
    p.add_argument("--distill-prosody-knowledge", type=strtobool,
                   default=True)
    return p


def model_config_from_args(args, idim, odim=80):
    from fcl_taco2_tpu_torch.models import ModelConfig

    return ModelConfig(
        idim=idim, odim=odim, embed_dim=args.embed_dim,
        elayers=args.elayers, eunits=args.eunits,
        econv_layers=args.econv_layers, econv_chans=args.econv_chans,
        econv_filts=args.econv_filts, use_residual=args.use_residual,
        dlayers=args.dlayers, dunits=args.dunits,
        prenet_layers=args.prenet_layers, prenet_units=args.prenet_units,
        postnet_layers=args.postnet_layers,
        postnet_chans=args.postnet_chans, postnet_filts=args.postnet_filts,
        use_batch_norm=args.use_batch_norm, use_concate=args.use_concate,
        reduction_factor=args.reduction_factor,
        dropout_rate=args.dropout_rate, zoneout_rate=args.zoneout_rate,
        zoneout_rng=args.zoneout_rng,
        # drop classes at/above max-dur (the top class is implicitly
        # max-dur) so the default "8,16,32" stays valid for any --max-dur
        duration_classes=tuple(
            d for d in (int(x) for x in
                        str(args.duration_classes or "").split(",")
                        if str(x).strip())
            if d < args.max_dur),
        use_masking=args.use_masking,
        use_weighted_masking=args.use_weighted_masking,
        spk_embed_dim=args.spk_embed_dim or 0,
        duration_predictor_layers=args.duration_predictor_layers,
        duration_predictor_chans=args.duration_predictor_chans,
        duration_predictor_kernel_size=args.duration_predictor_kernel_size,
        duration_predictor_dropout_rate=(
            args.duration_predictor_dropout_rate),
        use_fe_condition=args.use_fe_condition,
        append_position=args.append_position, max_dur=args.max_dur,
        compute_dtype=args.compute_dtype,
        remat_decoder=bool(args.remat_decoder),
        decoder_scan_unroll=args.decoder_scan_unroll)


def infer_idim_odim(valid_json):
    """Read idim/odim from the manifest like tts.py:318-336."""
    import json

    with open(valid_json) as f:
        utts = json.load(f)["utts"]
    first = next(iter(utts.values()))
    odim = int(first["input"][0]["shape"][1])
    idim = int(first["output"][0]["shape"][1])
    return idim, odim


def train_config_from_args(args):
    from fcl_taco2_tpu_torch.train.loop import TrainConfig

    return TrainConfig(
        exp_dir=args.outdir, epochs=args.epochs, batch_size=args.batch_size,
        sort_key=args.batch_sort_key, maxlen_in=args.maxlen_in,
        maxlen_out=args.maxlen_out, batch_bins=args.batch_bins,
        batch_frames_in=args.batch_frames_in,
        batch_frames_out=args.batch_frames_out,
        batch_frames_inout=args.batch_frames_inout,
        minibatches=args.minibatches, opt=args.opt, lr=args.lr,
        eps=args.eps, weight_decay=args.weight_decay,
        grad_clip=args.grad_clip, accum_grad=args.accum_grad,
        patience=args.patience,
        eval_interval_epochs=args.eval_interval_epochs,
        save_interval_epochs=args.save_interval_epochs,
        sortagrad=args.sortagrad, seed=args.seed,
        n_devices=args.n_devices, n_slices=args.n_slices,
        resume=args.resume, profile_dir=args.profile_dir,
        preprocess_conf=args.preprocess_conf,
        enc_init=args.enc_init, enc_init_mods=tuple(args.enc_init_mods),
        dec_init=args.dec_init, dec_init_mods=tuple(args.dec_init_mods),
        freeze_mods=tuple(args.freeze_mods),
        steps_per_dispatch=args.steps_per_dispatch,
        ckpt_opt_dtype=args.ckpt_opt_dtype,
        device_cache=args.device_cache,
        device_cache_max_mb=args.device_cache_max_mb,
        checkpoint_on_signal=True)


def main(argv=None):
    """Train; with several ranks (``--n-devices``) they are spawned here
    and this returns None, else the final ``TrainState``."""
    from fcl_taco2_tpu_torch.parallel.distributed import cli_ranks, run_ranks
    argv = argv if argv is not None else sys.argv[1:]
    args = parse_with_configs(get_parser(), argv)
    return run_ranks(_train_rank, cli_ranks(args.n_devices, args.device),
                     argv, args.device)


def _train_rank(device, argv):
    """One rank's training run on ``device``."""
    args = parse_with_configs(get_parser(), argv)
    args.device = str(device)

    import logging
    # reference --verbose semantics (tts_train.py:395-406)
    level = (logging.WARNING if args.verbose == 0
             else logging.INFO if args.verbose == 1 else logging.DEBUG)
    logging.basicConfig(
        level=level,
        format="%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: "
               "%(message)s")

    if args.debugmode >= 2:
        import torch
        torch.autograd.set_detect_anomaly(True)

    from fcl_taco2_tpu_torch.data import load_manifest
    from fcl_taco2_tpu_torch.models import Tacotron2SA
    from fcl_taco2_tpu_torch.train.loop import Trainer

    if args.remat_decoder is None:  # the JAX default: on for KD runs only
        args.remat_decoder = bool(args.perform_kd)

    idim, odim = infer_idim_odim(args.valid_json)
    train_utts = load_manifest(args.train_json, pad_eos=args.pad_eos)
    val_utts = load_manifest(args.valid_json, pad_eos=args.pad_eos)
    tcfg = train_config_from_args(args)

    if args.perform_kd:
        from fcl_taco2_tpu_torch.cli.fcl_distill import run_kd_training
        return run_kd_training(args, tcfg, idim, odim, train_utts, val_utts)
    model = Tacotron2SA(model_config_from_args(args, idim, odim),
                        device=args.device, seed=args.seed)
    trainer = Trainer(model, tcfg, train_utts, val_utts, device=args.device)
    return trainer.run()


if __name__ == "__main__":
    main()
