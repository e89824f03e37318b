"""Top-down COCO evaluation entry point: the clean pass of a robustness run.

    python -m advmix_tpu_torch.tools.validate --cfg <yaml> [--device cpu] \
        [KEY VALUE ...]

Port of `run_one("clean", 0)` of `tools/test_corruption.py:223-290`: build
the model, load TEST.MODEL_FILE (a reference `.pth`, or an `.npz` of JAX
variables, `models/convert.py`) or warn and evaluate the random init, run
`validate` once, and append the result to `robust_C.val`. It runs on the
CUDA device, and raises without one unless `--device cpu` is given.
"""

from __future__ import annotations

import os
import pprint

import torch

from ..config import get_default_config, update_config
from ..data import Loader, build_dataset
from ..engine.steps import make_eval_step
from ..engine.trainer import make_eval_preprocessor, validate
from ..models import get_pose_net, load_model_file
from ..models.layers import set_compute_dtype
from ..utils.device import resolve_device
from ..utils.logging import create_logger
from ._parse import parse_args


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
    model_file = cfg.TEST.MODEL_FILE or os.path.join(output_dir, "final_state")
    if os.path.isfile(model_file):
        load_model_file(model, model_file)
        logger.info(f"=> loaded model {model_file}")
    else:
        logger.warning(
            f"=> no model file at {model_file}; evaluating random init")
    model = set_compute_dtype(model.to(device).eval(), dtype)

    dataset = build_dataset(cfg, is_train=False)
    loader = Loader(dataset, cfg.TEST.BATCH_SIZE_PER_GPU)
    eval_step = make_eval_step(model, cfg, dataset.flip_pairs)
    prep = make_eval_preprocessor(cfg, device)
    name_values, perf = validate(cfg, eval_step, prep, dataset, loader,
                                 output_dir, device)
    with open(os.path.join(output_dir, "robust_C.val"), "a") as rec:
        rec.write("clean_0:\t")
        for k, v in name_values.items():
            rec.write(f"{k} = {v}\t")
        rec.write("\n")
    return name_values, perf


if __name__ == "__main__":
    main()
