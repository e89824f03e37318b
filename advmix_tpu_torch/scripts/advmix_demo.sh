#!/bin/bash
# End-to-end AdvMix robustness demonstration with the PyTorch/CUDA port:
# train the synthetic marker task standard, then --advmix with the
# standard run as teacher and D's warm start, and an equal-budget control
# (the standard run continued as many epochs); sweep all three through
# the full 15x5 on-the-fly corruption benchmark and report clean PCK, mPC
# and rPC = mPC / clean for each. AdvMix's rPC should beat the control's,
# as the paper claims. The port's counterpart of scripts/advmix_demo.sh.
#
# Usage: advmix_tpu_torch/scripts/advmix_demo.sh [workdir]
#        (default $TMPDIR/advmix_demo, or /tmp/advmix_demo)
# Knobs: those of arms.sh (EPOCHS, DEVICE, DISTORTIONS, AB_EXTRA_OPTS,
# OUTPUT_DIR, LOG_DIR, PYTHON).
set -e
cd "$(dirname "$0")/../.."
WORK=${1:-${TMPDIR:-/tmp}/advmix_demo}
mkdir -p "$WORK"
. advmix_tpu_torch/scripts/arms.sh

echo "=== [1/4] standard training ==="
train standard

echo "=== [2/4] advmix training (teacher + D init = standard run) ==="
train advmix "${ADVMIX_FLAGS[@]}" --load_from_D "$WORK/standard_state"

echo "=== [2b] equal-budget control: standard continued +200 epochs ==="
# the advmix arm fine-tunes its epochs on top of the standard run; the
# control gets the same total budget (the same restarted LR schedule),
# so that the mPC / rPC deltas are AdvMix's, not the extra training's
train standard400 --load_from_D "$WORK/standard_state"

echo "=== [3/4] corruption sweep: standard ==="
sweep "$WORK/standard_state" standard
echo "=== [3b] corruption sweep: standard400 (equal-budget control) ==="
sweep "$WORK/standard400_state" standard400
echo "=== [4/4] corruption sweep: advmix ==="
sweep "$WORK/advmix_state" advmix

"$PY" -m advmix_tpu_torch.scripts.demo_summary "$WORK"
