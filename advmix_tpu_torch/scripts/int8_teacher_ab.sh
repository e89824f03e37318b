#!/bin/bash
# A/B measurement of the int8-teacher KD accuracy cost with the
# PyTorch/CUDA port: the robust-demo advmix arm trained twice from the
# same standard-run warm start with the same seeds and budget, once with
# the f32 teacher and once with TRAIN.INT8_TEACHER (the frozen teacher's
# forward in W8A8, ops/quant.py), both swept through the full 15x5
# on-the-fly corruption benchmark. Output: clean PCK / mPC / rPC per arm
# and the deltas. The port's counterpart of scripts/int8_teacher_ab.sh.
#
# Usage: advmix_tpu_torch/scripts/int8_teacher_ab.sh [workdir]
#        (default $TMPDIR/int8_ab, or /tmp/int8_ab)
# Knobs: those of arms.sh. A workdir that already holds standard_state
# (advmix_demo.sh's) reuses it as the warm start.
set -e
cd "$(dirname "$0")/../.."
WORK=${1:-${TMPDIR:-/tmp}/int8_ab}
mkdir -p "$WORK"
. advmix_tpu_torch/scripts/arms.sh

if [ ! -f "$WORK/standard_state" ]; then
    echo "=== [1/5] standard training (teacher source) ==="
    train standard
fi

echo "=== [2/5] advmix arm A: f32 teacher ==="
train f32 "${ADVMIX_FLAGS[@]}" --load_from_D "$WORK/standard_state"

echo "=== [3/5] advmix arm B: int8 teacher (identical seeds/budget) ==="
train int8 "${ADVMIX_FLAGS[@]}" --load_from_D "$WORK/standard_state" \
    TRAIN.INT8_TEACHER true

echo "=== [4/5] corruption sweep: f32 teacher arm ==="
sweep "$WORK/f32_state" f32
echo "=== [5/5] corruption sweep: int8 teacher arm ==="
sweep "$WORK/int8_state" int8

"$PY" - "$WORK" <<'PYEOF'
import sys

from advmix_tpu_torch.scripts.demo_summary import read_arm

work = sys.argv[1]
a = read_arm(work, "f32")
b = read_arm(work, "int8")
print(f"{'arm':<14}{'clean':>8}{'mPC':>8}{'rPC':>8}")
print(f"{'f32 teacher':<14}{a[0]:>8.4f}{a[1]:>8.4f}{a[2]:>8.4f}")
print(f"{'int8 teacher':<14}{b[0]:>8.4f}{b[1]:>8.4f}{b[2]:>8.4f}")
print(f"{'delta (B-A)':<14}{b[0]-a[0]:>+8.4f}{b[1]-a[1]:>+8.4f}{b[2]-a[2]:>+8.4f}")
PYEOF
