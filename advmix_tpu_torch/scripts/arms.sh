# Shared by advmix_demo.sh and int8_teacher_ab.sh (sourced from the repo
# root): the robust-demo config, the knobs both read, and the two steps
# every arm takes, training to a state file and sweeping it.
#
# Knobs (environment), all optional:
#   EPOCHS         per-arm epoch budget; every arm gets the same, so the
#                  equal-budget comparisons hold at any depth (default:
#                  the config's TRAIN.END_EPOCH, 200)
#   DEVICE         --device of every entry point; "cpu" runs on the CPU
#                  (default: the CUDA device; without one the run stops)
#   DISTORTIONS    comma-separated subset of the sweep (default: the 15
#                  benchmark corruptions, x 5 severities)
#   AB_EXTRA_OPTS  extra "KEY VALUE ..." config overrides for every call
#                  (a CPU smoke shrinks the set: "DATASET.SYNTH_LENGTH 32")
#   OUTPUT_DIR, LOG_DIR  the config's output and log roots
#   PYTHON         the interpreter (default: python)

CFG=experiments/synthetic/res18_64x64_robust_demo.yaml
OUT_ROOT=${OUTPUT_DIR:-output}
OUT=$OUT_ROOT/synthetic/pose_resnet/res18_64x64_robust_demo
ROB=${OUT_ROOT}_robustness/synthetic/pose_resnet/test_corruption
PY=${PYTHON:-python}

OPTS=()
if [ -n "${OUTPUT_DIR:-}" ]; then OPTS+=(OUTPUT_DIR "$OUTPUT_DIR"); fi
if [ -n "${LOG_DIR:-}" ]; then OPTS+=(LOG_DIR "$LOG_DIR"); fi
if [ -n "${EPOCHS:-}" ]; then OPTS+=(TRAIN.END_EPOCH "$EPOCHS"); fi
if [ -n "${AB_EXTRA_OPTS:-}" ]; then OPTS+=($AB_EXTRA_OPTS); fi
# one rank: the entry points' default, 0, takes every card
DEV=(--num_devices 1)
if [ -n "${DEVICE:-}" ]; then DEV+=(--device "$DEVICE"); fi
SWEEP_FLAGS=()
if [ -n "${DISTORTIONS:-}" ]; then SWEEP_FLAGS=(--distortions "$DISTORTIONS"); fi

ADVMIX_FLAGS=(--advmix --sample_times 3 --kd_mseloss
              --alpha 0.1 --adv_loss_weight 1.0
              --gen_input_chn 9 --downsamples 6)

since () {  # wall seconds since $1, an $EPOCHREALTIME
    awk -v a="$1" -v b="$EPOCHREALTIME" 'BEGIN { printf "%.1f", b - a }'
}

train () {  # $1 = the arm's tag; the rest: its flags, then its overrides
    local tag=$1 t0=$EPOCHREALTIME
    shift
    rm -f "$OUT/final_state"
    "$PY" -m advmix_tpu_torch.tools.train --cfg $CFG "${DEV[@]}" "$@" \
        "${OPTS[@]}"
    # the port's final_state is one torch file
    rm -rf "$WORK/${tag}_state"
    cp "$OUT/final_state" "$WORK/${tag}_state"
    echo "=== ${tag}: trained in $(since "$t0") s"
}

sweep () {  # $1 = state file, $2 = tag
    # the sweep evaluates the random init, with only a warning, when its
    # model file is missing: never sweep a state file that is not there
    if [ ! -f "$1" ]; then
        echo "$(basename "$0"): no state file $1: not sweeping random" \
             "weights" >&2
        exit 1
    fi
    local t0=$EPOCHREALTIME
    rm -f "$ROB/robust_C.val" "$ROB/robust.csv"
    "$PY" -m advmix_tpu_torch.tools.test_corruption --cfg $CFG --on_the_fly \
        "${DEV[@]}" "${SWEEP_FLAGS[@]}" TEST.MODEL_FILE "$1" "${OPTS[@]}"
    cp "$ROB/robust_C.val" "$WORK/robust_$2.val"
    cp "$ROB/robust.csv" "$WORK/results_$2.csv"
    echo "=== $2: swept in $(since "$t0") s"
}
