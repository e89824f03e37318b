#!/usr/bin/env bash
# Corruption-robustness sweep (clean + 15 corruptions x 5 severities ->
# robust_C.val and the mPC / rPC CSV) on the PyTorch/CUDA port. The port's
# counterpart of scripts/test.sh (the reference's scripts/test.sh surface).
# Extra flags (e.g. "--on_the_fly --distortions fog") go via $FLAGS; "$@"
# appends yacs KEY VALUE config overrides.
# Knobs: CFG, MODEL_FILE, EXP_ID, FLAGS, DEVICE (--device; "cpu" runs on
# the CPU), PYTHON (default: python).
set -e
cd "$(dirname "$0")/../.."
CFG="${CFG:-experiments/coco/resnet/res50_256x192_advmix.yaml}"
MODEL_FILE="${MODEL_FILE:-output/coco/pose_resnet/res50_256x192_advmix/final_state}"
# the sweep evaluates the random init, with only a warning, when its model
# file is missing: stop instead
if [ ! -f "$MODEL_FILE" ]; then
  echo "test.sh: no model file $MODEL_FILE: not sweeping random weights" >&2
  exit 1
fi
DEV=()
if [ -n "${DEVICE:-}" ]; then DEV=(--device "$DEVICE"); fi
"${PYTHON:-python}" -m advmix_tpu_torch.tools.test_corruption \
  --cfg "$CFG" \
  --exp_id "${EXP_ID:-robust}" \
  "${DEV[@]}" \
  ${FLAGS:-} \
  TEST.MODEL_FILE "$MODEL_FILE" \
  "$@"
