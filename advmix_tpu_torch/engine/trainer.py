"""Host-side training and validation loops.

Port of `advmix_tpu/engine/trainer.py` (reference `tools/train.py:283-328`
and `lib/core/function.py`), single process. Training: the threaded Loader
feeds uint8 crops (or, with DATASET.DEVICE_WARP, padded source images and
crop matrices), the device warps, normalizes, synthesizes the three AdvMix
views and builds the Gaussian targets, and each iteration is one call of a
step of `engine/steps.py`. Validation: the eval step decodes, and the host
gathers the predictions in dataset order for `dataset.evaluate`.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from ..ops.augment import IMAGENET_MEAN, IMAGENET_STD, make_advmix_views
from ..ops.corruptions import BENCHMARK_CORRUPTIONS, corrupt, \
    device_generator
from ..ops.heatmap import generate_target
from ..ops.transforms import warp_affine
from ..utils.logging import LOGGER_NAME, AverageMeter, print_name_value

logger = logging.getLogger(LOGGER_NAME)

def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor; through pinned memory, asynchronously,
    when the device is a card."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def make_random_corruption_fn():
    """Per-image random (type, severity) corruption for the
    `--random_corruption` baseline (reference `JointsDataset.py:284-286`
    draws per image in __getitem__), on one device.

    `fn(img, generator, branches=None)` draws one of the 75 (type,
    severity) branches of the 15 benchmark corruptions per image of the
    NHWC float batch from `generator` (on the host: no device sync) and
    applies each image's branch with its random form, drawing from a
    generator on the batch's device. `branches` injects the per-image
    branch indices. The 4 holdout types are never drawn, as the
    reference's baseline hardcodes the 15 (`JointsDataset.py:259-264`), so
    the held-out mPC protocol stays uncontaminated."""
    n_branches = len(BENCHMARK_CORRUPTIONS) * 5

    def fn(img: torch.Tensor, generator: torch.Generator, branches=None):
        if branches is None:
            branches = torch.randint(0, n_branches, (img.shape[0],),
                                     generator=generator).tolist()
        g = device_generator(generator, img.device)
        return torch.cat([
            corrupt(img[i:i + 1], BENCHMARK_CORRUPTIONS[br // 5], br % 5 + 1,
                    g)
            for i, br in enumerate(branches)])

    fn.n_branches = n_branches
    return fn


def make_preprocessor(cfg, advmix: bool, device: torch.device,
                      sp_style: bool = False, device_warp: bool = False,
                      random_corruption: bool = False):
    """Device-side batch preparation for training: uint8 crops (B, H, W, 3)
    or, with `device_warp`, padded source images and crop matrices
    (`ops/transforms.warp_affine`) -> normalized NCHW views or images, and
    Gaussian targets. `prep(raw, generator)` takes the device tensors named
    in `prep.required` and the generator of the augmentation's draws.

    The views are synthesized at the training compute dtype: in bf16 the
    augment moves half the bytes for at most one uint8 level of drift.
    `sp_style`: the views take the per-sample `is_style` mask.
    `random_corruption`: each image gets a random benchmark corruption
    (`make_random_corruption_fn`) before the views."""
    image_size = tuple(cfg.MODEL.IMAGE_SIZE)
    heatmap_size = tuple(cfg.MODEL.HEATMAP_SIZE)
    sigma = float(cfg.MODEL.SIGMA)
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32,
                        device=device).view(1, 3, 1, 1) * 255.0
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32,
                       device=device).view(1, 3, 1, 1) * 255.0
    view_dtype = (torch.bfloat16 if str(cfg.TRAIN.DTYPE) == "bfloat16"
                  else None)
    corrupt_fn = make_random_corruption_fn() if random_corruption else None

    @torch.no_grad()
    def prep(raw, generator):
        img = raw["image"]
        if device_warp:
            img = warp_affine(img, raw["warp_matrix"], image_size)
        img = img.to(torch.float32)
        if corrupt_fn is not None:
            img = corrupt_fn(img, generator)
        img = img.permute(0, 3, 1, 2)  # NHWC -> NCHW
        target, _, tw = generate_target(raw["joints"], raw["joints_vis"],
                                        image_size, heatmap_size, sigma)
        if advmix:
            views = make_advmix_views(
                img, generator, style_mask=raw.get("is_style"),
                out_dtype=view_dtype, compute_dtype=view_dtype)
            return {"views": views, "target": target, "target_weight": tw}
        return {"image": ((img - mean) / std).contiguous(), "target": target,
                "target_weight": tw}

    prep.required = tuple(["image", "joints", "joints_vis"]
                          + (["warp_matrix"] if device_warp else [])
                          + (["is_style"] if sp_style else []))
    return prep


def make_eval_preprocessor(cfg, device: torch.device,
                           corruption: str | None = None, severity: int = 1):
    """prep(image_u8 (B, H, W, 3), joints (B, J, 2), joints_vis (B, J)) ->
    {image: normalized f32 NHWC, target (B, J, Hh, Hw), target_weight}.

    With a `corruption` other than "clean" the crops are corrupted first,
    in the exact-render form at `severity` (1..5), every batch from a
    generator seeded 1, as the JAX sweep corrupts every batch with
    PRNGKey(1) (`tools/test_corruption.py:112-125`)."""
    image_size = tuple(cfg.MODEL.IMAGE_SIZE)
    heatmap_size = tuple(cfg.MODEL.HEATMAP_SIZE)
    sigma = float(cfg.MODEL.SIGMA)
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32,
                        device=device) * 255.0
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32,
                       device=device) * 255.0

    corrupted = corruption not in (None, "", "clean")

    def prep(image_u8, joints, joints_vis):
        img = image_u8.to(torch.float32)
        if corrupted:
            img = corrupt(img, corruption, severity,
                          torch.Generator(img.device).manual_seed(1),
                          exact_render=True)
        target, _, tw = generate_target(joints, joints_vis, image_size,
                                        heatmap_size, sigma)
        return {"image": (img - mean) / std, "target": target,
                "target_weight": tw}

    return prep


def train_epoch(cfg, step_fn, prep_fn, loader, device: torch.device,
                epoch: int, generator: torch.Generator,
                advmix: bool = False):
    """One epoch of steps (reference `train` / `train_advmix`). Returns the
    per-iteration metrics as floats."""
    batch_time = AverageMeter()
    data_time = AverageMeter()
    losses = AverageMeter()
    accs = AverageMeter()
    history = []
    end = time.time()
    for i, host_batch in enumerate(loader):
        data_time.update(time.time() - end)
        missing = [k for k in prep_fn.required if k not in host_batch]
        if missing:
            raise KeyError(
                f"loader batch lacks {missing} required by the preprocessor "
                "(device_warp needs Loader(raw_mode=True))")
        raw = {k: to_device(host_batch[k], device) for k in prep_fn.required}
        batch = prep_fn(raw, generator)
        metrics = {k: float(v) for k, v in step_fn(batch).items()}
        history.append(metrics)

        n = host_batch["_n"]
        losses.update(metrics["loss_d" if advmix else "loss"], n)
        accs.update(metrics["acc"], int(metrics["acc_cnt"]))
        batch_time.update(time.time() - end)
        end = time.time()
        if i % cfg.PRINT_FREQ == 0:
            logger.info(
                f"Epoch: [{epoch}][{i}/{len(loader)}]\t"
                f"Time {batch_time.val:.3f}s ({batch_time.avg:.3f}s)\t"
                f"Speed {n / max(batch_time.val, 1e-9):.1f} samples/s\t"
                f"Data {data_time.val:.3f}s ({data_time.avg:.3f}s)\t"
                f"Loss {losses.val:.5f} ({losses.avg:.5f})\t"
                f"Accuracy {accs.val:.3f} ({accs.avg:.3f})")
    return history


def output_dir_of(cfg) -> str:
    """The debug-dump directory, derived as `create_logger` derives its
    own."""
    return os.path.join(cfg.OUTPUT_DIR or "output", cfg.DATASET.DATASET,
                        cfg.MODEL.NAME, "debug")


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
