"""Corruption-robustness sweep: the clean pass and every corruption at
severities 1..5, aggregated into mPC and rPC.

    python -m advmix_tpu_torch.tools.test_corruption --cfg <yaml> \
        [--on_the_fly] [--distortions a,b] [--all_corruptions] \
        [--device cpu] [KEY VALUE ...]

Port of `tools/test_corruption.py:46-334` (reference `tools/test_corruption.py`):
build and load the model once (TEST.MODEL_FILE, a
reference `.pth` or an `.npz` of JAX variables, as `tools/validate.py`
loads it; without one the random init is evaluated, with a warning; a
directory stops the run), build
the eval step once, evaluate clean + each corruption x severities 1..5,
append one line per pass to robust_C.val, and write a CSV with the clean AP,
the per-corruption means, mPC (the mean over the 15 benchmark corruptions
only) and rAP = mPC / clean; on an MPII YAML the score is PCKh Mean and the
CSV's columns are clean_mean, mean_corrupted_mean and rmean.
`--all_corruptions` also sweeps the 4 holdout types; `--distortions` sweeps
a subset. A bottom-up YAML (pose_higher_hrnet) evaluates every pass with
`validate_bottomup`, which corrupts the whole input image
(:130,185-188,249-256).

With `--on_the_fly` the crops are corrupted on the device in the
exact-render form (`ops/corruptions.py`): one dataset of clean crops, whose
prepared batches are replayed from host memory after the first pass
(`data/loader.CachedLoader`). Without it each pass reads the pre-rendered
tree `<ROOT_C>/<corruption>/<severity 0-4>/` (`data/coco-C` or
`data/mpii-C`; `tools/make_datasets.py` writes one). It runs on the CUDA
device, and raises without one unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import csv
import os
import pprint

import torch

from ..config import get_default_config, update_config
from ..data import CachedLoader, Loader
from ..data import build_dataset as default_build_dataset
from ..engine import trainer as trainer_lib
from ..engine.steps import make_bottomup_eval_step, make_eval_step
from ..engine.trainer import make_eval_preprocessor, validate
from ..models import get_pose_net
from ..models.layers import set_compute_dtype
from ..ops.corruptions import BENCHMARK_CORRUPTIONS, HOLDOUT_CORRUPTIONS
from ..utils.device import resolve_device
from ..utils.logging import create_logger
from ._parse import parse_args, reject_later_slices
from .validate import load_test_model_file

BENCHMARK_15 = list(BENCHMARK_CORRUPTIONS)
HOLDOUT_4 = list(HOLDOUT_CORRUPTIONS)


def main(argv=None, build_dataset=default_build_dataset):
    """Run the sweep. `build_dataset(cfg, is_train, image_set)` makes the
    eval datasets (the default reads cfg.DATASET). Returns a dict with the
    per-pass (corruption, severity0, name_values, perf), the CSV's path and
    the output directory."""
    # the sweep's own flags on top of the shared surface
    extra = argparse.ArgumentParser(add_help=False)
    extra.add_argument("--all_corruptions", default=False,
                       action="store_true")
    extra.add_argument("--on_the_fly", default=False, action="store_true")
    extra.add_argument("--distortions", type=str, default="",
                       help="comma-separated subset to sweep (default: the "
                            "15 benchmark corruptions)")
    extra_args, rest = extra.parse_known_args(argv)
    args = parse_args(rest)
    device = resolve_device(args.device)
    args.test_robust = True
    cfg = get_default_config()
    update_config(cfg, args)
    reject_later_slices(args, cfg)
    if cfg.TEST.INT8:
        raise SystemExit("not ported yet: TEST.INT8 needs ops/quant.py: the "
                         "int8 and serving slice")

    logger, output_dir, _ = create_logger(cfg, args.cfg, "valid")
    logger.info(pprint.pformat(vars(args)) + "\n"
                + pprint.pformat(vars(extra_args)))
    logger.info("=> device %s", device)
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = bool(cfg.CUDNN.BENCHMARK)
    dtype = (torch.bfloat16 if (args.dtype or cfg.TRAIN.DTYPE) == "bfloat16"
             else torch.float32)

    # build and load the model once (reference val_model_init, :38-58)
    model = get_pose_net(cfg)
    load_test_model_file(model, cfg, output_dir, logger)
    model = set_compute_dtype(model.to(device).eval(), dtype)

    def dataset_for(corruption: str, severity0: int, robust: bool):
        cfg.defrost()
        cfg.TEST.CORRUPTION_TYPE = corruption
        cfg.TEST.SEVERITY = severity0
        cfg.TEST.TEST_ROBUST = robust
        cfg.freeze()
        return build_dataset(cfg, False, None)

    # the eval step is the same for the whole sweep: build it once
    first = dataset_for("clean", 0, False)
    bottomup = cfg.MODEL.NAME == "pose_higher_hrnet"
    if bottomup:
        eval_step = make_bottomup_eval_step(
            model, cfg, first.flip_pairs,
            scales=tuple(cfg.TEST.SCALE_FACTOR))
    else:
        eval_step = make_eval_step(model, cfg, first.flip_pairs)
    batch = cfg.TEST.BATCH_SIZE_PER_GPU
    # on the fly, every pass reads the same clean crops and the device
    # corrupts them: the host's work is the same on every pass
    cached = (first, CachedLoader(Loader(first, batch))) \
        if extra_args.on_the_fly else None

    def run_one(corruption: str, severity0: int):
        """severity0 is the 0-based index the -C tree's directories use;
        on-the-fly synthesis takes severity0 + 1 (1..5)."""
        if cached is not None:
            dataset, loader = cached
        else:
            dataset = dataset_for(corruption, severity0, True)
            loader = Loader(dataset, batch)
        cfg.defrost()
        cfg.TEST.CORRUPTION_TYPE = corruption
        cfg.TEST.SEVERITY = severity0
        cfg.TEST.TEST_ROBUST = True
        cfg.freeze()
        on_device = corruption if extra_args.on_the_fly else None
        if bottomup:
            name_values, perf = trainer_lib.validate_bottomup(
                cfg, eval_step, dataset, loader, output_dir, device,
                corruption=on_device, severity=severity0 + 1)
        else:
            prep = make_eval_preprocessor(cfg, device, corruption=on_device,
                                          severity=severity0 + 1)
            name_values, perf = validate(cfg, eval_step, prep, dataset,
                                         loader, output_dir, device)
        with open(os.path.join(output_dir, "robust_C.val"), "a") as rec:
            rec.write(f"{corruption}_{severity0}:\t")
            for k, v in name_values.items():
                rec.write(f"{k} = {v}\t")
            rec.write("\n")
        return name_values, perf

    if extra_args.distortions:
        distortions = extra_args.distortions.split(",")
    else:
        distortions = BENCHMARK_15 + (
            HOLDOUT_4 if extra_args.all_corruptions else [])
    passes = [("clean", 0)] + [(name, s) for name in distortions
                               for s in range(5)]
    runs = []
    for corruption, severity0 in passes:
        name_values, perf = run_one(corruption, severity0)
        runs.append((corruption, severity0, name_values, perf))
    path = write_final_csv([r[3] for r in runs], distortions, output_dir,
                           args.exp_id or "robust", cfg.DATASET.DATASET)
    return dict(runs=runs, csv=path, output_dir=output_dir)


def write_final_csv(results, distortions, output_dir, exp_id, dataset_name):
    """Aggregate CSV (get_final_results[_mpii], :150-192), with the length
    assert corrected to the actual 1 + len(distortions)*5 runs."""
    expected = 1 + len(distortions) * 5
    assert len(results) == expected, (len(results), expected)
    results = list(results)
    clean = results.pop(0)

    metric = "mean" if dataset_name == "mpii" else "mAP"
    row = {f"clean_{metric}": round(clean, 3)}
    mpc_sum, mpc_n = 0.0, 0
    for i, dis in enumerate(distortions):
        vals = results[i * 5 : i * 5 + 5]
        row[dis] = round(sum(vals) / len(vals), 3)
        if dis in BENCHMARK_15:
            mpc_sum += row[dis]
            mpc_n += 1
    mpc = mpc_sum / max(mpc_n, 1)
    row[f"mean_corrupted_{metric}"] = round(mpc, 3)
    row["rAP" if metric == "mAP" else "rmean"] = round(mpc / clean, 3) if clean else 0.0

    columns = (
        [f"clean_{metric}", f"mean_corrupted_{metric}",
         "rAP" if metric == "mAP" else "rmean"]
        + distortions
    )
    path = os.path.join(output_dir, f"{exp_id}.csv")
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=columns)
        writer.writeheader()
        writer.writerow({k: row[k] for k in columns})
    print(f"=> wrote {path}")
    return path


if __name__ == "__main__":
    main()
