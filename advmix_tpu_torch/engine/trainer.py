"""Host-side validation driver.

Port of `advmix_tpu/engine/trainer.py:make_eval_preprocessor` and
`validate` (reference `lib/core/function.py:200-360`), single process: the
threaded Loader feeds uint8 crops, the device normalizes them and builds
the Gaussian targets, the eval step decodes, and the host gathers the
predictions in dataset order for `dataset.evaluate`.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from ..ops.heatmap import generate_target
from ..utils.logging import LOGGER_NAME, AverageMeter, print_name_value

logger = logging.getLogger(LOGGER_NAME)

# ImageNet mean / std; scaled to 0..255 in f32 as
# advmix_tpu/ops/augment.py:28-31 does
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor; through pinned memory, asynchronously,
    when the device is a card."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def make_eval_preprocessor(cfg, device: torch.device):
    """prep(image_u8 (B, H, W, 3), joints (B, J, 2), joints_vis (B, J)) ->
    {image: normalized f32 NHWC, target (B, J, Hh, Hw), target_weight}."""
    image_size = tuple(cfg.MODEL.IMAGE_SIZE)
    heatmap_size = tuple(cfg.MODEL.HEATMAP_SIZE)
    sigma = float(cfg.MODEL.SIGMA)
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32,
                        device=device) * 255.0
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32,
                       device=device) * 255.0

    def prep(image_u8, joints, joints_vis):
        img = image_u8.to(torch.float32)
        target, _, tw = generate_target(joints, joints_vis, image_size,
                                        heatmap_size, sigma)
        return {"image": (img - mean) / std, "target": target,
                "target_weight": tw}

    return prep


def validate(cfg, eval_step, prep_fn, dataset, loader, output_dir: str,
             device: torch.device):
    """One validation pass + `dataset.evaluate`. Returns
    (name_values, perf)."""
    losses = AverageMeter()
    accs = AverageMeter()
    num_samples = len(dataset)
    all_preds = np.zeros((num_samples, dataset.num_joints, 3), np.float32)
    all_boxes = np.zeros((num_samples, 6))
    all_indices = np.zeros(num_samples, np.int64)
    image_paths = []
    idx = 0
    t_device = 0.0

    for host_batch in loader:
        bsz = len(host_batch["image"])
        n = host_batch["_n"]
        raw = {
            "image": to_device(host_batch["image"], device),
            "joints": to_device(host_batch["joints"], device),
            "joints_vis": to_device(host_batch["joints_vis"], device),
            "center": to_device(host_batch["center"].astype(np.float32),
                                device),
            "scale": to_device(host_batch["scale"].astype(np.float32),
                               device),
            "valid": to_device((np.arange(bsz) < n).astype(np.float32),
                               device),
        }
        batch = prep_fn(raw["image"], raw["joints"], raw["joints_vis"])
        batch.update(center=raw["center"], scale=raw["scale"],
                     valid=raw["valid"])
        t0 = time.time()
        preds, maxvals, metrics = eval_step(batch)
        preds = preds.cpu().numpy()
        maxvals = maxvals.cpu().numpy()
        t_device += time.time() - t0

        losses.update(float(metrics["loss"]), n)
        accs.update(float(metrics["acc"]), int(metrics["acc_cnt"]))

        s = host_batch["scale"][:n]
        all_preds[idx: idx + n, :, 0:2] = preds[:n]
        all_preds[idx: idx + n, :, 2:3] = maxvals[:n]
        all_boxes[idx: idx + n, 0:2] = host_batch["center"][:n]
        all_boxes[idx: idx + n, 2:4] = s
        all_boxes[idx: idx + n, 4] = np.prod(s * 200, 1)
        all_boxes[idx: idx + n, 5] = host_batch["score"][:n]
        all_indices[idx: idx + n] = host_batch["_indices"][:n]
        image_paths.extend(host_batch["image_path"][:n])
        idx += n

    logger.info("=> The average device time per batch: %.4fs",
                t_device / max(len(loader), 1))
    logger.info("=> loss %.6f  acc %.4f", losses.avg, accs.avg)
    name_values, perf = dataset.evaluate(
        cfg, all_preds[:idx], output_dir, all_boxes[:idx], image_paths,
        indices=all_indices[:idx], device=device,
    )
    print_name_value(logger, name_values, cfg.MODEL.NAME)
    return name_values, perf
