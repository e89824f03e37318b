"""Real-data accuracy-parity harness.

    python -m advmix_tpu_torch.tools.parity_check \
        --cfg experiments/coco/hrnet/w32_256x192_advmix.yaml \
        --ckpt /path/to/advmix_hrnet_w32.pth \
        [--method advmix] [--expect_ap 74.7] [--expect_mpc 55.5] \
        [--tol 0.3] [--sweep [--on_the_fly]] [--device cpu] [KEY VALUE ...]

Counterpart of `tools/parity_check.py`, with its contract (`:1-25`,
`:78-279`): load `--ckpt` (a reference `.pth`, an `.npz` of JAX
variables, or the port's own checkpoint; a JAX orbax `final_state`
directory stops the run with `tools/validate.py:load_test_model_file`'s
message), run the port's `validate()` (`validate_bottomup` for
pose_higher_hrnet) for the clean AP, with `--sweep` the port's 15 x 5
corruption sweep (`tools/test_corruption.main`) for mPC, and diff every
metric against `--expect_*` or `BASELINE_TABLE` (keyed by `arch_key` and
`--method`) within `--tol`; beating the expectation is a pass. Exit codes:
0 when every check passes, 1 on a miss, 2 when there is no expectation, the
checkpoint is missing or the sweep fails; 0 with "PARITY SKIPPED" when the
dataset is absent, so the command doubles as an environment smoke. The last
line is the JSON report. It runs on the card unless `--device cpu` is given.

Expected values: the reference's README.md:60-76 (BASELINE.md, with the
+-0.3 tolerance from the randomness inside `imagecorruptions`).
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import pprint
import traceback

import torch

from ..config import get_default_config
from ..data import Loader
from ..data import build_dataset as default_build_dataset
from ..engine import trainer as trainer_lib
from ..engine.steps import make_bottomup_eval_step, make_eval_step
from ..models import get_pose_net
from ..models.layers import set_compute_dtype
from ..utils.device import resolve_device
from ..utils.logging import create_logger
from . import test_corruption
from .validate import load_test_model_file

# (clean AP, mPC, rPC) per (arch key, method): the reference's README.md:60-76
# (BASELINE.md). rPC is mPC / AP, listed for the report.
BASELINE_TABLE = {
    ("resnet_50_256x192", "standard"): (70.4, 47.8, 67.9),
    ("resnet_50_256x192", "advmix"): (70.1, 50.1, 71.5),
    ("resnet_101_256x192", "standard"): (71.4, 49.6, 69.5),
    ("resnet_101_256x192", "advmix"): (71.3, 52.3, 73.3),
    ("resnet_152_256x192", "standard"): (72.0, 50.9, 70.7),
    ("resnet_152_256x192", "advmix"): (72.3, 53.2, 73.6),
    ("hrnet_w32_256x192", "standard"): (74.4, 53.0, 71.3),
    ("hrnet_w32_256x192", "advmix"): (74.7, 55.5, 74.3),
    ("hrnet_w48_256x192", "standard"): (75.1, 53.7, 71.6),
    ("hrnet_w48_256x192", "advmix"): (75.4, 57.1, 75.7),
    ("higher_hrnet_w32_512x512", "standard"): (67.1, 39.9, 59.4),
    ("higher_hrnet_w32_512x512", "advmix"): (68.3, 45.4, 66.5),
}


def arch_key(cfg) -> str:
    """The BASELINE_TABLE key of a config (`tools/parity_check.py:63`)."""
    w, h = cfg.MODEL.IMAGE_SIZE
    size = f"{int(h)}x{int(w)}"
    extra = dict(cfg.MODEL.EXTRA)
    if cfg.MODEL.NAME == "pose_resnet":
        return f"resnet_{extra.get('NUM_LAYERS', 50)}_{size}"
    width = dict(extra.get("STAGE2", {})).get("NUM_CHANNELS", [32])[0]
    if cfg.MODEL.NAME == "pose_hrnet":
        return f"hrnet_w{width}_{size}"
    if cfg.MODEL.NAME == "pose_higher_hrnet":
        return f"higher_hrnet_w{width}_{size}"
    return f"{cfg.MODEL.NAME}_{size}"


def _as_percent(v: float) -> float:
    """Datasets report AP in [0, 1]; the published table is in percent."""
    return v * 100.0 if v <= 1.0 else v


def clean_pass(cfg, model, dataset, output_dir: str, device) -> float:
    """The clean AP of `model` on `dataset` through the port's validate."""
    loader = Loader(dataset, cfg.TEST.BATCH_SIZE_PER_GPU)
    if cfg.MODEL.NAME == "pose_higher_hrnet":
        step = make_bottomup_eval_step(model, cfg, dataset.flip_pairs,
                                       scales=tuple(cfg.TEST.SCALE_FACTOR))
        _, ap = trainer_lib.validate_bottomup(cfg, step, dataset, loader,
                                              output_dir, device)
    else:
        step = make_eval_step(model, cfg, dataset.flip_pairs)
        prep = trainer_lib.make_eval_preprocessor(cfg, device)
        _, ap = trainer_lib.validate(cfg, step, prep, dataset, loader,
                                     output_dir, device)
    return ap


def sweep_mpc(args, device, build_dataset) -> float:
    """mPC from the port's corruption sweep, read from the CSV it writes."""
    argv = ["--cfg", args.cfg, "--device", str(device), "--num_devices", "1"]
    if args.on_the_fly:
        argv.append("--on_the_fly")
    argv += ["TEST.MODEL_FILE", args.ckpt] + [o for o in args.opts if o]
    res = test_corruption.main(argv, build_dataset=build_dataset)
    with open(res["csv"]) as f:
        row = next(csv.DictReader(f))
    key = ("mean_corrupted_mAP" if "mean_corrupted_mAP" in row
           else "mean_corrupted_mean")
    return _as_percent(float(row[key]))


def main(argv=None, build_dataset=default_build_dataset) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--ckpt", "--torch_ckpt", dest="ckpt", required=True,
                    help="reference .pth, .npz of JAX variables, or the "
                         "port's own checkpoint")
    ap.add_argument("--method", choices=["advmix", "standard"],
                    default="advmix",
                    help="the BASELINE row to check against when no "
                         "--expect_* is given")
    ap.add_argument("--expect_ap", type=float, default=None)
    ap.add_argument("--expect_mpc", type=float, default=None)
    ap.add_argument("--tol", type=float, default=0.3,
                    help="allowed |measured - expected| (BASELINE.md: +-0.3 "
                         "from imagecorruptions' randomness)")
    ap.add_argument("--sweep", action="store_true",
                    help="also the 15x5 corruption sweep for mPC/rPC")
    ap.add_argument("--on_the_fly", action="store_true",
                    help="corrupt on the device instead of reading a "
                         "rendered <dataset>-C tree")
    ap.add_argument("--allow_random_init", action="store_true",
                    help="testing only: proceed without a checkpoint")
    ap.add_argument("--device", type=str, default=None,
                    help="default: the CUDA device (raises without one)")
    ap.add_argument("opts", nargs=argparse.REMAINDER, default=[],
                    help="extra 'KEY VALUE' config overrides")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_default_config()
    cfg.merge_from_file(args.cfg)
    if args.opts:
        cfg.merge_from_list([o for o in args.opts if o])
    cfg.TEST.MODEL_FILE = args.ckpt
    cfg.freeze()

    # ---- data presence probe: SKIP (exit 0) when the dataset is absent ----
    try:
        dataset = build_dataset(cfg, False, None)
    except (FileNotFoundError, OSError, KeyError) as e:
        print(f"PARITY SKIPPED: dataset '{cfg.DATASET.DATASET}' not "
              f"available in this environment ({type(e).__name__}: {e}). "
              f"Run this command on a machine with {cfg.DATASET.ROOT} "
              "populated.")
        return 0

    # ---- expectations ----
    key = arch_key(cfg)
    base = BASELINE_TABLE.get((key, args.method))
    expect_ap, expect_mpc = args.expect_ap, args.expect_mpc
    if expect_ap is None and base:
        expect_ap = base[0]
    if expect_mpc is None and base and args.sweep:
        expect_mpc = base[1]
    if expect_ap is None:
        print(f"PARITY ERROR: no --expect_ap and no BASELINE row for "
              f"({key}, {args.method}); known rows: "
              f"{sorted(k for k, _ in BASELINE_TABLE)}")
        return 2

    logger, output_dir, _ = create_logger(cfg, args.cfg, "parity")
    logger.info(pprint.pformat(vars(args)))
    logger.info(f"=> parity target ({key}, {args.method}): AP={expect_ap} "
                f"mPC={expect_mpc} tol={args.tol}; device {device}")

    # ---- model and checkpoint ----
    model = get_pose_net(cfg)
    if args.ckpt.endswith((".pth", ".npz")) and not os.path.exists(
            args.ckpt):
        print(f"PARITY ERROR: checkpoint {args.ckpt} not found")
        return 2
    if os.path.exists(args.ckpt):
        # a directory (a JAX orbax final_state) stops the run here
        load_test_model_file(model, cfg, output_dir, logger)
    elif not args.allow_random_init:
        print(f"PARITY ERROR: checkpoint {args.ckpt} not found")
        return 2
    else:
        logger.warning("=> no checkpoint: evaluating random init")
    dtype = (torch.bfloat16 if cfg.TRAIN.DTYPE == "bfloat16"
             else torch.float32)
    model = set_compute_dtype(model.to(device).eval(), dtype)
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = bool(cfg.CUDNN.BENCHMARK)

    clean_ap = _as_percent(clean_pass(cfg, model, dataset, output_dir,
                                      device))
    mpc = None
    if args.sweep:
        try:
            mpc = sweep_mpc(args, device, build_dataset)
        except Exception:  # the report says why; the exit code says failed
            print(f"PARITY ERROR: corruption sweep failed\n"
                  f"{traceback.format_exc()[-2000:]}")
            return 2

    # ---- verdict ----
    checks = [("clean AP", clean_ap, expect_ap)]
    if mpc is not None and expect_mpc is not None:
        checks.append(("mPC", mpc, expect_mpc))
    report = {"arch": key, "method": args.method, "tol": args.tol,
              "device": str(device), "checks": []}
    ok = True
    for name, measured, expected in checks:
        delta = measured - expected
        # beating the paper is a pass, not a parity failure
        passed = delta > 0 or abs(delta) <= args.tol
        ok &= passed
        report["checks"].append(
            {"metric": name, "measured": round(measured, 3),
             "expected": expected, "delta": round(delta, 3),
             "pass": bool(passed)})
        logger.info(f"=> {name}: measured {measured:.3f} vs expected "
                    f"{expected} (delta {delta:+.3f}) -> "
                    f"{'PASS' if passed else 'FAIL'}")
    if mpc is not None and clean_ap > 0:
        report["rPC"] = round(100.0 * mpc / clean_ap, 2)
    report["result"] = "PASS" if ok else "FAIL"
    print(json.dumps(report), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
