#!/usr/bin/env bash
# Student (FCL-taco2-S) knowledge-distillation training with the PyTorch
# port, the flags of scripts/student_model_training.sh (seed 137, batch
# 32, --perform-KD True --share-proj True).
#
#   bash scripts/torch_student_model_training.sh [extra fcl_train flags]
#
# FEATURE_ROOT (default data), EXP (default exp/student), TEACHER_CKPT
# (default exp/teacher/results/model.loss.best) and DEVICE (default cuda,
# passed as --device).  Extra flags come last and override these.
set -euo pipefail
cd "$(dirname "$0")/.."

FEATURE_ROOT=${FEATURE_ROOT:-data}
EXP=${EXP:-exp/student}
TEACHER_CKPT=${TEACHER_CKPT:-exp/teacher/results/model.loss.best}
DEVICE=${DEVICE:-cuda}

python -m fcl_taco2_tpu_torch.cli.fcl_train \
    --config conf/train_fcl_taco2.student.yaml \
    --train-json "$FEATURE_ROOT/train_data.json" \
    --valid-json "$FEATURE_ROOT/val_data.json" \
    --outdir "$EXP/results" \
    --seed 137 \
    --batch-size 32 \
    --perform-KD True \
    --share-proj True \
    --teacher-config conf/train_fcl_taco2.teacher.yaml \
    --teacher-checkpoint "$TEACHER_CKPT" \
    --device "$DEVICE" \
    "$@"
