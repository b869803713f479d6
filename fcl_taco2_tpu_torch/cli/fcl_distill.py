#!/usr/bin/env python3
"""Knowledge-distillation training driver (port of
``fcl_taco2_tpu/cli/fcl_distill.py``), run from ``fcl_train`` with
``--perform-KD True`` (reference tts_train.py:433-438 -> tts_distill.py).
The teacher's hyperparameters come from ``--teacher-config``, its weights
from ``--teacher-checkpoint``."""


def run_kd_training(args, tcfg, idim, odim, train_utts, val_utts):
    from fcl_taco2_tpu_torch.cli.fcl_train import (get_parser,
                                                   model_config_from_args)
    from fcl_taco2_tpu_torch.models.kd import KDStudent
    from fcl_taco2_tpu_torch.train.distill import KDTrainer
    from fcl_taco2_tpu_torch.utils.cliconf import parse_with_configs

    if not args.teacher_checkpoint:
        raise SystemExit("--perform-KD True requires --teacher-checkpoint "
                         "(the reference requires the teacher amp "
                         "checkpoint too, tts_distill.py:370-375)")

    # the teacher's hyperparameters come from their own yaml, as
    # teacher_parser.py does
    teacher_args = parse_with_configs(
        get_parser(),
        ["--config", args.teacher_config,
         "--train-json", args.train_json, "--valid-json", args.valid_json])
    teacher_cfg = model_config_from_args(teacher_args, idim, odim)
    student_cfg = model_config_from_args(args, idim, odim)

    kd = KDStudent(
        student_cfg, teacher_cfg, share_proj=args.share_proj,
        distill_output=args.distill_output_knowledge,
        distill_encoder=args.distill_encoder_knowledge,
        distill_decoder=args.distill_decoder_knowledge,
        distill_prosody=args.distill_prosody_knowledge,
        device=args.device, seed=args.seed)
    trainer = KDTrainer(kd, tcfg, train_utts, val_utts,
                        teacher_checkpoint=args.teacher_checkpoint,
                        device=args.device)
    return trainer.run()


if __name__ == "__main__":
    raise SystemExit("run via fcl_train --perform-KD True")
