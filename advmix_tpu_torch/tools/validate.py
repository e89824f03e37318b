"""Evaluation entry point: the clean pass of a robustness run.

    python -m advmix_tpu_torch.tools.validate --cfg <yaml> [--device cpu] \
        [KEY VALUE ...]

Port of `run_one("clean", 0)` of `tools/test_corruption.py:223-290`: build
the model, load TEST.MODEL_FILE (a reference `.pth`, or an `.npz` of JAX
variables, `models/convert.py`) or warn and evaluate the random init, run
`validate` once (`validate_bottomup`, with TEST.SCALE_FACTOR, for
pose_higher_hrnet), and append the result to `robust_C.val`. A directory
as the model file (a JAX orbax `final_state`) stops the run: the port
reads orbax only through an `.npz`. It runs on the CUDA device, and raises
without one unless `--device cpu` is given.
"""

from __future__ import annotations

import os
import pprint

import torch

from ..config import get_default_config, update_config
from ..data import Loader, build_dataset
from ..engine import trainer as trainer_lib
from ..engine.steps import make_bottomup_eval_step, make_eval_step
from ..models import get_pose_net, load_model_file
from ..models.layers import set_compute_dtype
from ..utils.device import resolve_device
from ..utils.logging import create_logger
from ._parse import parse_args


def load_test_model_file(model, cfg, output_dir: str, logger) -> None:
    """Load TEST.MODEL_FILE, or `<output_dir>/final_state`, into `model`;
    a missing file leaves the random init, with a warning. A directory
    stops the run: it is a JAX orbax `final_state`, which the port cannot
    read without jax."""
    model_file = cfg.TEST.MODEL_FILE or os.path.join(output_dir, "final_state")
    if os.path.isdir(model_file):
        raise SystemExit(
            f"TEST.MODEL_FILE {model_file} is a directory (a JAX orbax "
            "final_state?): the port cannot read orbax without jax. Save "
            "its params and batch_stats as an .npz of '/'-joined paths, "
            "which models/convert.py reads, and give that file")
    if os.path.isfile(model_file):
        load_model_file(model, model_file)
        logger.info(f"=> loaded model {model_file}")
    else:
        logger.warning(
            f"=> no model file at {model_file}; evaluating random init")


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    # the clean pass runs with the robustness flags of the sweep
    # (test_corruption.py:58,226-233): outputs go to the robustness tree
    args.test_robust = True
    args.severity = 0
    cfg = get_default_config()
    update_config(cfg, args)
    cfg.defrost()
    cfg.TEST.CORRUPTION_TYPE = "clean"
    cfg.freeze()

    logger, output_dir, _ = create_logger(cfg, args.cfg, "valid")
    logger.info(pprint.pformat(vars(args)))
    logger.info("=> device %s", device)
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = bool(cfg.CUDNN.BENCHMARK)
    dtype = (torch.bfloat16 if (args.dtype or cfg.TRAIN.DTYPE) == "bfloat16"
             else torch.float32)

    model = get_pose_net(cfg)
    load_test_model_file(model, cfg, output_dir, logger)
    model = set_compute_dtype(model.to(device).eval(), dtype)

    dataset = build_dataset(cfg, is_train=False)
    loader = Loader(dataset, cfg.TEST.BATCH_SIZE_PER_GPU)
    if cfg.MODEL.NAME == "pose_higher_hrnet":
        eval_step = make_bottomup_eval_step(
            model, cfg, dataset.flip_pairs,
            scales=tuple(cfg.TEST.SCALE_FACTOR))
        name_values, perf = trainer_lib.validate_bottomup(
            cfg, eval_step, dataset, loader, output_dir, device)
    else:
        eval_step = make_eval_step(model, cfg, dataset.flip_pairs)
        prep = trainer_lib.make_eval_preprocessor(cfg, device)
        name_values, perf = trainer_lib.validate(
            cfg, eval_step, prep, dataset, loader, output_dir, device)
    with open(os.path.join(output_dir, "robust_C.val"), "a") as rec:
        rec.write("clean_0:\t")
        for k, v in name_values.items():
            rec.write(f"{k} = {v}\t")
        rec.write("\n")
    return name_values, perf


if __name__ == "__main__":
    main()
