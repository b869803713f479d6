#!/usr/bin/env bash
# Teacher (FCL-taco2-T) training with the PyTorch port, the flags of
# scripts/teacher_model_training.sh (seed 137, batch 32, no KD).
#
#   bash scripts/torch_teacher_model_training.sh [extra fcl_train flags]
#
# FEATURE_ROOT (default data) holds train_data.json and val_data.json;
# EXP (default exp/teacher) receives the run; DEVICE (default cuda) is
# passed as --device.  Extra flags come last and override these.
set -euo pipefail
cd "$(dirname "$0")/.."

FEATURE_ROOT=${FEATURE_ROOT:-data}
EXP=${EXP:-exp/teacher}
DEVICE=${DEVICE:-cuda}

python -m fcl_taco2_tpu_torch.cli.fcl_train \
    --config conf/train_fcl_taco2.teacher.yaml \
    --train-json "$FEATURE_ROOT/train_data.json" \
    --valid-json "$FEATURE_ROOT/val_data.json" \
    --outdir "$EXP/results" \
    --seed 137 \
    --batch-size 32 \
    --perform-KD False \
    --device "$DEVICE" \
    "$@"
