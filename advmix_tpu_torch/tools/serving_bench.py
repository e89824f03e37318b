"""Serving-throughput bench: the eval step, bf16 against int8.

    python -m advmix_tpu_torch.tools.serving_bench --cfg <yaml> \
        [--arm bf16|int8|int8pre] [--batch 128] [--steps 20] [KEY VALUE ...]

Port of `tools/serving_bench.py`: the step that the sweep and the server
run (forward, the flip-test ensemble, decode; bottom-up: the device half
of `validate_bottomup`) on seeded random weights and images at a fixed
batch. The arms: `bf16` (TRAIN.DTYPE as given), `int8` (W8A8 with the
weights quantized on every call, `ops/quant.quantize_model`) and `int8pre`
(weights stored int8, `ops/quant.prequantize_params`). The int8 arms
calibrate on 4 random images: the time does not depend on the ranges.
Timing: CUDA events around two windows of `--steps` back-to-back steps
after 3 warm-ups, host launch time included, best of the two. It prints
the card's name and power limit and one JSON line per run (img/s, ms per
batch, the windows). It raises without a card: a CPU time is not a
measurement of the port.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..config import get_default_config, update_config
from ..engine.steps import make_bottomup_eval_step, make_eval_step
from ..models import he_reinit_convs, get_pose_net
from ..models.layers import set_compute_dtype
from ..ops import quant
from ..ops.heatmap import generate_target
from ..utils.device import resolve_device
from ._parse import one_device_only, parse_args
from .bench import card_line

ARMS = ("bf16", "int8", "int8pre")


def make_serving_workload(cfg, arm: str, batch_size: int,
                          device: torch.device, dtype: torch.dtype,
                          seed: int = 0):
    """(the eval step, one batch on `device`) of `arm` at `batch_size`,
    He-initialized seeded weights."""
    if arm not in ARMS:
        raise ValueError(f"arm must be one of {ARMS}: {arm}")
    rng = np.random.RandomState(seed)
    model = get_pose_net(cfg)
    he_reinit_convs(model, torch.Generator().manual_seed(seed))
    model = model.to(device).eval()
    w, h = cfg.MODEL.IMAGE_SIZE
    if arm == "bf16":
        model = set_compute_dtype(model, dtype)
    else:
        set_compute_dtype(model, dtype, trainable=True)
        calib = torch.from_numpy(rng.randn(4, 3, h, w).astype(np.float32))
        scales = quant.calibrate_act_scales(model, [calib.to(device)])
        model = (quant.prequantize_params(model, scales)[0]
                 if arm == "int8pre" else quant.quantize_model(model, scales))
    image = torch.from_numpy(rng.randn(batch_size, h, w, 3).astype(
        np.float32)).to(device)
    if cfg.MODEL.NAME == "pose_higher_hrnet":
        step = make_bottomup_eval_step(model, cfg, [[1, 2]],
                                       scales=tuple(cfg.TEST.SCALE_FACTOR))
        return step, {"image": image}
    step = make_eval_step(model, cfg, [[1, 2]])
    hw, hh = cfg.MODEL.HEATMAP_SIZE
    j = cfg.MODEL.NUM_JOINTS
    joints = torch.from_numpy(rng.uniform(
        0, min(w, h) - 2, (batch_size, j, 2)).astype(np.float32)).to(device)
    vis = torch.ones((batch_size, j), device=device)
    target, _, tw = generate_target(joints, vis, (w, h), (hw, hh),
                                    float(cfg.MODEL.SIGMA))
    batch = {"image": image, "target": target, "target_weight": tw,
             "center": torch.from_numpy(rng.uniform(
                 100, 200, (batch_size, 2)).astype(np.float32)).to(device),
             "scale": torch.from_numpy(rng.uniform(
                 0.8, 1.5, (batch_size, 2)).astype(np.float32)).to(device)}
    return step, batch


def time_serving(cfg, arm: str, batch_size: int, steps: int,
                 device: torch.device, dtype: torch.dtype) -> dict:
    """img/s of `steps` back-to-back eval steps, best of two windows."""
    if device.type != "cuda":
        raise RuntimeError("serving_bench measures the CUDA device only")
    step, batch = make_serving_workload(cfg, arm, batch_size, device, dtype)
    for _ in range(3):
        step(batch)
    windows = []
    for _ in range(2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(steps):
            step(batch)
        end.record()
        end.synchronize()
        windows.append(batch_size * steps / (start.elapsed_time(end) / 1e3))
    best = max(windows)
    w, h = cfg.MODEL.IMAGE_SIZE
    return {
        "metric": f"{cfg.MODEL.NAME} {w}x{h} eval/serving throughput ({arm}, "
                  f"batch {batch_size}, flip_test={bool(cfg.TEST.FLIP_TEST)})",
        "arm": arm, "value": best, "unit": "img/s",
        "ms_per_batch": batch_size / best * 1e3, "windows": windows,
        "batch": batch_size, "steps": steps,
    }


def main(argv=None):
    extra = argparse.ArgumentParser(add_help=False)
    extra.add_argument("--arm", default="bf16", choices=ARMS)
    extra.add_argument("--batch", type=int, default=128)
    extra.add_argument("--steps", type=int, default=20)
    extra_args, rest = extra.parse_known_args(argv)
    args = parse_args(rest)
    one_device_only(args, "serving_bench")
    device = resolve_device(args.device)
    cfg = get_default_config()
    update_config(cfg, args)
    torch.backends.cudnn.benchmark = bool(cfg.CUDNN.BENCHMARK)
    dtype = (torch.bfloat16 if (args.dtype or cfg.TRAIN.DTYPE) == "bfloat16"
             else torch.float32)
    out = time_serving(cfg, extra_args.arm, extra_args.batch,
                       extra_args.steps, device, dtype)
    card = card_line()
    print(card, flush=True)
    out.update(device=torch.cuda.get_device_name(0), card=card)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
