#!/usr/bin/env bash
# The PyTorch port's whole quality protocol on one card, at the JAX
# protocol's defaults: the F0 truth check, torch_mcd_benchmark.py's
# teacher stage, the int8 and serving-distribution scripts on its
# teacher, the KD student stage, then the duration script on both.
#
#   bash scripts/torch_quality_protocol.sh [OUT_DIR] [WORKDIR]
#
# OUT_DIR (default results/) receives the five TORCH_*.json files, each
# script's log and the two trainers' log.jsonl; WORKDIR (default
# $TMPDIR/fcl_torch_mcd_run) holds the corpus, features, checkpoints and
# decodes.  Each step's exit code is printed; a later step that needs an
# earlier one's files fails on its own.
O=${1:-results}
W=${2:-${TMPDIR:-/tmp}/fcl_torch_mcd_run}
S=$(dirname "$0")
mkdir -p "$O"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 -c "import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)"
run() {  # run TAG SCRIPT ARGS...: log to $O/TAG.log, print the exit code
    local tag=$1; shift
    python3 -u "$@" > "$O/$tag.log" 2>&1
    echo "$tag rc=$?"
}
run f0 "$S/torch_f0_groundtruth_eval.py" --out "$O/TORCH_F0_groundtruth.json"
run mcd_teacher "$S/torch_mcd_benchmark.py" --stage teacher --workdir "$W" \
    --out "$O/TORCH_MCD_e2e.json"
cp "$W/exp_teacher/log.jsonl" "$O/teacher_log.jsonl"
run quant "$S/torch_quant_quality.py" --workdir "$W" \
    --out "$O/TORCH_QUANT_decode.json"
run decode "$S/torch_decode_protocol.py" \
    --model "$W/exp_teacher/model.loss.best" \
    --json "$W/features/train_data.json" --workdir "$W/proto" \
    --out "$O/TORCH_DECODE_protocol.json"
run mcd_student "$S/torch_mcd_benchmark.py" --stage student --workdir "$W" \
    --out "$O/TORCH_MCD_e2e.json"
cp "$W/exp_student/log.jsonl" "$O/student_log.jsonl"
run dur "$S/torch_dur_quality.py" --feat-dir "$W/features" \
    --teacher-exp "$W/exp_teacher" --student-exp "$W/exp_student" \
    --out "$O/TORCH_DUR_quality.json"
for f in "$O"/*.log; do echo "== $f"; tail -n 4 "$f"; done
