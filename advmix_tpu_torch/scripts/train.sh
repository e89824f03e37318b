#!/usr/bin/env bash
# AdvMix training with a pretrained pose checkpoint as D + teacher, on the
# PyTorch/CUDA port. The port's counterpart of scripts/train.sh (the
# reference's scripts/train.sh surface). "$@" appends flags, then yacs
# KEY VALUE config overrides.
# Knobs: CFG, LOAD_FROM_D, DEVICE (--device; "cpu" runs on the CPU),
# PYTHON (default: python).
set -e
cd "$(dirname "$0")/../.."
CFG="${CFG:-experiments/coco/resnet/res50_256x192_advmix.yaml}"
LOAD_FROM_D="${LOAD_FROM_D:-models/pose_resnet_50_coco.pth}"
ARGS=(--cfg "$CFG" --advmix --sample_times 3 --kd_mseloss --alpha 0.1)
if [ -n "${DEVICE:-}" ]; then ARGS+=(--device "$DEVICE"); fi
if [ -f "$LOAD_FROM_D" ]; then
  ARGS+=(--load_from_D "$LOAD_FROM_D")
else
  echo "WARNING: pretrained checkpoint '$LOAD_FROM_D' not found;" \
       "training D + teacher from random init" >&2
fi
"${PYTHON:-python}" -m advmix_tpu_torch.tools.train "${ARGS[@]}" "$@"
