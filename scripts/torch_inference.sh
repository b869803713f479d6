#!/usr/bin/env bash
# Decode the test split to mel with the PyTorch port, as
# scripts/inference.sh does (shard -> decode).
#
#   bash scripts/torch_inference.sh [teacher|student] [shard-count] \
#       [shard-index] [extra fcl_synth flags]
#
# FEATURE_ROOT (default data), EXP (default exp/ROLE), CKPT (default
# EXP/results/model.loss.best) and DEVICE (default cuda, passed as
# --device).  The feats.scp written is parallel-wavegan-decode compatible;
# `python -m fcl_taco2_tpu_torch.cli.fcl_vocode --feats-scp ...` vocodes
# it with the port's PWG.
set -euo pipefail
cd "$(dirname "$0")/.."

ROLE=${1:-teacher}
PARTS=${2:-1}
IDX=${3:-1}
shift $(( $# < 3 ? $# : 3 ))
FEATURE_ROOT=${FEATURE_ROOT:-data}
EXP=${EXP:-exp/$ROLE}
CKPT=${CKPT:-$EXP/results/model.loss.best}
DEVICE=${DEVICE:-cuda}

JSON="$FEATURE_ROOT/test_data.json"
if [ "$PARTS" -gt 1 ]; then
    python -m fcl_taco2_tpu_torch.cli.fcl_splitjson "$JSON" --parts "$PARTS"
    JSON="$FEATURE_ROOT/split${PARTS}utt/test_data.${IDX}.json"
fi

python -m fcl_taco2_tpu_torch.cli.fcl_synth \
    --model "$CKPT" \
    --json "$JSON" \
    --out "$EXP/outputs_$(basename "$CKPT")_$IDX" \
    --device "$DEVICE" \
    "$@"
