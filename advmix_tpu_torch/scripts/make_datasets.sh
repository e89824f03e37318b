#!/usr/bin/env bash
# Render the COCO-C and MPII-C corruption datasets on the card with the
# PyTorch/CUDA port. The port's counterpart of scripts/make_datasets.sh
# (the reference's scripts/make_datasets.sh surface); "$@" appends flags.
# Knobs: COCO_ROOT, MPII_ROOT, OUT_ROOT, DEVICE (--device; "cpu" renders
# on the CPU), PYTHON (default: python).
set -e
cd "$(dirname "$0")/../.."
COCO_ROOT="${COCO_ROOT:-data/coco/val2017}"
MPII_ROOT="${MPII_ROOT:-data/mpii/images}"
OUT_ROOT="${OUT_ROOT:-data}"
DEV=()
if [ -n "${DEVICE:-}" ]; then DEV=(--device "$DEVICE"); fi
if [ -d "$COCO_ROOT" ]; then
  "${PYTHON:-python}" -m advmix_tpu_torch.tools.make_datasets \
    --dataset_root "$COCO_ROOT" --out_root "$OUT_ROOT" --out_file coco-C \
    "${DEV[@]}" "$@"
else
  echo "WARNING: $COCO_ROOT not found; skipping COCO-C" >&2
fi
if [ -d "$MPII_ROOT" ]; then
  "${PYTHON:-python}" -m advmix_tpu_torch.tools.make_datasets \
    --dataset_root "$MPII_ROOT" --out_root "$OUT_ROOT" --out_file mpii-C \
    "${DEV[@]}" "$@"
else
  echo "WARNING: $MPII_ROOT not found; skipping MPII-C" >&2
fi
