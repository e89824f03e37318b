"""Host-side training and validation loops.

Port of `advmix_tpu/engine/trainer.py` (reference `tools/train.py:283-328`
and `lib/core/function.py`). Training: the threaded Loader
feeds uint8 crops (or, with DATASET.DEVICE_WARP, padded source images and
crop matrices), the device warps, normalizes, synthesizes the three AdvMix
views and builds the Gaussian targets, and each iteration is one call of a
step of `engine/steps.py`. Validation: the eval step decodes, and the host
gathers the predictions in dataset order for `dataset.evaluate`. With
DEBUG.DEBUG (steps built with `debug=True`) both loops dump joint-overlay
and heatmap grids (`utils/vis.py`) every PRINT_FREQ batches into
`output_dir_of(cfg)`, and read the debug outputs back only on those batches
(`lib/core/function.py:92-95, 194-197, 301-316`).

Bottom-up (HigherHRNet): `make_bottomup_preprocessor` normalizes the
whole-image crops (or synthesizes the AdvMix views) and hands the joints
and the valid mask on, the targets being made inside the step;
`train_epoch_bottomup` runs an epoch of it; `validate_bottomup` runs the
eval step (peaks on the device), groups on the host
(`evaluation/grouping.py`), projects the people back through the inverse
affine and scores them with the COCO keypoint AP
(`advmix_tpu/engine/trainer.py:445-650`).

Over several ranks (`parallel/dist.py`) each rank loads its shard of every
batch; `validate` and `validate_bottomup`, given the data `group`, gather
the ranks' rows to rank 0 by dataset index (`merge_prediction_shards`),
score them there, and broadcast the score, as the JAX `validate` gathers
its processes' shards (`trainer.py:256-268, 381-413`). Only rank 0 logs
and dumps.
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
from ..parallel import dist as pdist
from ..utils.logging import LOGGER_NAME, AverageMeter, print_name_value
from ..utils.profiling import span

logger = logging.getLogger(LOGGER_NAME)

def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor; through pinned memory, asynchronously,
    when the device is a card."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def rank_generator(seed: int) -> torch.Generator:
    """The host generator of a training run's random draws (the AdvMix
    views, `--random_corruption`'s branches): seeded with `seed` on one
    rank, with the rank folded in on several (`parallel.dist.fold_rank`),
    so that the ranks draw differently."""
    return torch.Generator().manual_seed(pdist.fold_rank(seed))


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
    the held-out mPC protocol stays uncontaminated. Over several ranks
    `generator` is the rank's own (`rank_generator`, as the JAX function
    folds the replica index into its key), so the ranks draw different
    branches."""
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
        with span("advmix.train_prep"):
            return _prep(raw, generator)

    def _prep(raw, generator):
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
        with span("advmix.eval_prep"):
            img = image_u8.to(torch.float32)
            if corrupted:
                with span("advmix.corrupt"):
                    img = corrupt(img, corruption, severity,
                                  torch.Generator(img.device).manual_seed(1),
                                  exact_render=True)
            target, _, tw = generate_target(joints, joints_vis, image_size,
                                            heatmap_size, sigma)
            return {"image": (img - mean) / std, "target": target,
                    "target_weight": tw}

    return prep


def _host_inputs(host_batch: dict, required) -> dict:
    """The preprocessor's inputs from a loader batch. A batch without
    `is_style` (a dataset that is not a stylized ConcatDataset) gets zeros,
    with one warning: the --sp_style exemption is then inactive."""
    host = {}
    for k in required:
        if k in host_batch:
            host[k] = host_batch[k]
        elif k == "is_style":
            if not getattr(_host_inputs, "_warned_is_style", False):
                _host_inputs._warned_is_style = True
                logger.warning(
                    "batch lacks 'is_style'; zero-filling: the --sp_style "
                    "AutoAugment/GridMask exemption is inactive for these "
                    "samples")
            host[k] = np.zeros(len(host_batch["image"]), np.float32)
        else:
            raise KeyError(
                f"loader batch lacks '{k}' required by the preprocessor "
                "(device_warp needs Loader(raw_mode=True))")
    return host


def _nhwc(x: torch.Tensor) -> np.ndarray:
    """An NCHW device tensor as an f32 NHWC host array."""
    return x.detach().to(torch.float32).permute(0, 2, 3, 1).cpu().numpy()


def _save_dumps(cfg, host_batch, image_norm, target, debug_out, prefix):
    from ..utils.vis import save_debug_images

    output = _nhwc(debug_out["output"])
    pred = debug_out["pred_coords"].cpu().numpy()
    stride = image_norm.shape[1] / output.shape[1]
    save_debug_images(cfg, image_norm, host_batch["joints"],
                      host_batch["joints_vis"], target, pred * stride,
                      output, prefix)


def _dump_debug_images(cfg, host_batch, batch, debug_out, out_dir, epoch,
                       i, advmix):
    """The training dumps (reference `save_debug_images` call sites,
    `lib/core/function.py:92-95, 194-197`): `train_<epoch>_<i>_*.jpg` of
    the input (the clean view under AdvMix), and `..._mixed_*.jpg` of the
    adversarial mix."""
    os.makedirs(out_dir, exist_ok=True)
    prefix = os.path.join(out_dir, f"train_{epoch}_{i}")
    image = batch["views"][:, :3] if advmix else batch["image"]
    target = _nhwc(batch["target"])
    _save_dumps(cfg, host_batch, _nhwc(image), target, debug_out, prefix)
    if advmix:
        _save_dumps(cfg, host_batch, _nhwc(debug_out["mixed"]), target,
                    debug_out, prefix + "_mixed")


def _dump_val_debug_images(cfg, host_batch, batch, debug_out, out_dir, i):
    """The validation dumps (`lib/core/function.py:301-316`):
    `val_<i>_*.jpg`."""
    os.makedirs(out_dir, exist_ok=True)
    _save_dumps(cfg, host_batch, batch["image"].cpu().numpy(),
                _nhwc(batch["target"]), debug_out,
                os.path.join(out_dir, f"val_{i}"))


def train_epoch(cfg, step_fn, prep_fn, loader, device: torch.device,
                epoch: int, generator: torch.Generator,
                advmix: bool = False):
    """One epoch of steps (reference `train` / `train_advmix`). Returns the
    per-iteration metrics as floats. A step built with `debug=True`
    returns (metrics, debug outputs); with DEBUG.DEBUG its outputs are
    dumped every PRINT_FREQ iterations."""
    batch_time = AverageMeter()
    data_time = AverageMeter()
    losses = AverageMeter()
    accs = AverageMeter()
    history = []
    end = time.time()
    for i, host_batch in enumerate(loader):
        data_time.update(time.time() - end)
        raw = {k: to_device(v, device) for k, v in
               _host_inputs(host_batch, prep_fn.required).items()}
        batch = prep_fn(raw, generator)
        result = step_fn(batch)
        debug_out = None
        if isinstance(result, tuple):
            result, debug_out = result
        metrics = {k: float(v) for k, v in result.items()}
        history.append(metrics)

        n = host_batch["_n"]
        losses.update(metrics["loss_d" if advmix else "loss"], n)
        accs.update(metrics["acc"], int(metrics["acc_cnt"]))
        batch_time.update(time.time() - end)
        end = time.time()
        if i % cfg.PRINT_FREQ == 0:
            if debug_out is not None and cfg.DEBUG.DEBUG and pdist.is_main():
                _dump_debug_images(cfg, host_batch, batch, debug_out,
                                   output_dir_of(cfg), epoch, i, advmix)
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


def merge_prediction_shards(parts):
    """Merge per-rank eval outputs into one prediction set
    (`advmix_tpu/engine/trainer.py:256-268`).

    parts: list over ranks of (indices (n_p,), preds (n_p, J, 3),
    boxes (n_p, 6)). Returns (indices, preds, boxes) concatenated and
    stably ordered by global dataset index: the set an unsharded pass
    produces (the shards are disjoint by construction)."""
    idx = np.concatenate([np.asarray(p[0], np.int64) for p in parts])
    preds = np.concatenate([np.asarray(p[1]) for p in parts])
    boxes = np.concatenate([np.asarray(p[2]) for p in parts])
    order = np.argsort(idx, kind="stable")
    return idx[order], preds[order], boxes[order]


def validate(cfg, eval_step, prep_fn, dataset, loader, output_dir: str,
             device: torch.device, debug_out_dir: str | None = None,
             group=None):
    """One validation pass + `dataset.evaluate`. Returns
    (name_values, perf). With `debug_out_dir` and an eval step built with
    `debug=True`, the DEBUG.* dumps of every PRINT_FREQ-th batch go
    there. With the data `group` of several ranks (each `loader` a shard),
    the ranks' rows are gathered to rank 0, evaluated there, and the
    result is broadcast."""
    losses = AverageMeter()
    accs = AverageMeter()
    num_samples = len(dataset)
    all_preds = np.zeros((num_samples, dataset.num_joints, 3), np.float32)
    all_boxes = np.zeros((num_samples, 6))
    all_indices = np.zeros(num_samples, np.int64)
    image_paths = []
    idx = 0
    t_device = 0.0

    for bi, host_batch in enumerate(loader):
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
        step_out = eval_step(batch)
        preds, maxvals, metrics = step_out[:3]
        if debug_out_dir is not None and len(step_out) == 4 \
                and bi % cfg.PRINT_FREQ == 0 and pdist.is_main():
            _dump_val_debug_images(cfg, host_batch, batch, step_out[3],
                                   debug_out_dir, bi)
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
    if group is None:
        name_values, perf = dataset.evaluate(
            cfg, all_preds[:idx], output_dir, all_boxes[:idx], image_paths,
            indices=all_indices[:idx], device=device,
        )
        print_name_value(logger, name_values, cfg.MODEL.NAME)
        return name_values, perf
    parts = pdist.gather_to_main((all_indices[:idx], all_preds[:idx],
                                  all_boxes[:idx], image_paths))
    result = None
    if pdist.is_main():
        indices, preds, boxes = merge_prediction_shards(parts)
        path_of = {int(i): p for part in parts
                   for i, p in zip(part[0], part[3])}
        result = dataset.evaluate(
            cfg, preds, output_dir, boxes, [path_of[int(i)] for i in indices],
            indices=indices, device=device)
        print_name_value(logger, result[0], cfg.MODEL.NAME)
    return pdist.broadcast_from_main(result)


# ---------------------------------------------------------------------------
# Bottom-up (HigherHRNet)
# ---------------------------------------------------------------------------

def make_bottomup_preprocessor(cfg, advmix: bool, device: torch.device):
    """`prep(raw, generator)`: uint8 whole-image crops (B, S, S, 3) ->
    normalized NCHW `image`, or the AdvMix `views` at the training compute
    dtype; `joints`, `joints_vis` and an optional `mask` pass through."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32,
                        device=device).view(1, 3, 1, 1) * 255.0
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32,
                       device=device).view(1, 3, 1, 1) * 255.0
    view_dtype = (torch.bfloat16 if str(cfg.TRAIN.DTYPE) == "bfloat16"
                  else None)

    @torch.no_grad()
    def prep(raw, generator):
        img = raw["image"].to(torch.float32).permute(0, 3, 1, 2)
        out = {"joints": raw["joints"], "joints_vis": raw["joints_vis"]}
        if advmix:
            out["views"] = make_advmix_views(img, generator,
                                             out_dtype=view_dtype,
                                             compute_dtype=view_dtype)
        else:
            out["image"] = ((img - mean) / std).contiguous()
        if raw.get("mask") is not None:
            out["mask"] = raw["mask"]
        return out

    return prep


def train_epoch_bottomup(cfg, step_fn, prep_fn, loader, device: torch.device,
                         epoch: int, generator: torch.Generator,
                         advmix: bool = False):
    """One bottom-up epoch (the joints stay multi-person; PCK is not
    defined). Returns the per-iteration metrics as floats."""
    batch_time = AverageMeter()
    losses = AverageMeter()
    history = []
    end = time.time()
    for i, host_batch in enumerate(loader):
        raw = {k: to_device(host_batch[k], device)
               for k in ("image", "joints", "joints_vis", "mask")
               if k in host_batch}
        metrics = {k: float(v) for k, v in
                   step_fn(prep_fn(raw, generator)).items()}
        history.append(metrics)
        n = host_batch["_n"]
        losses.update(metrics["loss_d" if advmix else "loss"], n)
        batch_time.update(time.time() - end)
        end = time.time()
        if i % cfg.PRINT_FREQ == 0:
            logger.info(
                f"Epoch: [{epoch}][{i}/{len(loader)}]\t"
                f"Time {batch_time.val:.3f}s ({batch_time.avg:.3f}s)\t"
                f"Speed {n / max(batch_time.val, 1e-9):.1f} samples/s\t"
                f"Loss {losses.val:.5f} ({losses.avg:.5f})")
    return history


def validate_bottomup(cfg, eval_step, dataset, loader, output_dir: str,
                      device: torch.device, detection_thresh: float = 0.1,
                      tag_thresh: float = 1.0, corruption: str = "",
                      severity: int = 0, stats: dict | None = None,
                      group=None):
    """Bottom-up validation: the eval step's forward and peaks on the
    device (after an on-the-fly `corruption` at `severity` 1..5, seeded 1
    every batch as the top-down sweep's), AE grouping on the host, the
    inverse affine back to image coordinates, a COCO results json and the
    OKS AP. Returns (name_values, AP). `stats`, if given, receives the
    pass's host-clock seconds: `device_s` (step to read-back), `group_s`,
    `eval_s`, and the counts `images` and `groups` (over all ranks; the
    seconds are rank 0's). With the data `group` of several ranks (each
    `loader` a shard), the people found are gathered to rank 0 in dataset
    order, scored there, and the result is broadcast."""
    import json

    from ..evaluation.cocoeval_np import STATS_NAMES, COCOKeypointEval
    from ..evaluation.grouping import parse_bottomup
    from ..ops.transforms import get_affine_transform
    from collections import OrderedDict

    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32,
                        device=device) * 255.0
    # the reciprocal, as XLA compiles the JAX package's division by the
    # constant: the same f32 inputs, so grouping sees the same maps
    inv_std = 1.0 / (torch.tensor(IMAGENET_STD, dtype=torch.float32,
                                  device=device) * 255.0)
    corrupted = corruption not in (None, "", "clean")
    results, owners = [], []  # the people found, their image's index
    t = dict(device_s=0.0, group_s=0.0, eval_s=0.0, images=0, groups=0)
    for host_batch in loader:
        t0 = time.perf_counter()
        img = to_device(host_batch["image"], device).to(torch.float32)
        if corrupted:
            img = corrupt(img, corruption, severity,
                          torch.Generator(img.device).manual_seed(1),
                          exact_render=True)
        heat, tags, peaks = eval_step({"image": (img - mean) * inv_std})
        heat = heat.cpu().numpy()
        tags = tags.cpu().numpy()
        peaks = {k: v.cpu().numpy() for k, v in peaks.items()}
        t1 = time.perf_counter()
        t["device_s"] += t1 - t0
        hm_h, hm_w = heat.shape[2], heat.shape[3]
        for i in range(host_batch["_n"]):
            # (J, H, W[, T]) -> the grouping's (H, W, J[, T]), as views
            people, scores = parse_bottomup(
                heat[i].transpose(1, 2, 0), np.moveaxis(tags[i], 0, 2),
                {k: v[i] for k, v in peaks.items()}, detection_thresh,
                tag_thresh)
            t["images"] += 1
            t["groups"] += len(people)
            if len(people) == 0:
                continue
            inv = get_affine_transform(host_batch["center"][i],
                                       host_batch["scale"][i], 0,
                                       (hm_w, hm_h), inv=True)
            image_id = int(str(host_batch["image_path"][i])[-16:-4])
            for p, sc in zip(people, scores):
                kps = np.zeros(dataset.num_joints * 3)
                xy = np.concatenate([p[:, :2], np.ones((p.shape[0], 1))],
                                    axis=1) @ inv.T
                kps[0::3] = xy[:, 0]
                kps[1::3] = xy[:, 1]
                kps[2::3] = p[:, 2]
                results.append(dict(image_id=image_id, category_id=1,
                                    keypoints=[float(v) for v in kps],
                                    score=float(sc)))
                owners.append(int(host_batch["_indices"][i]))
        t["group_s"] += time.perf_counter() - t1

    if group is not None:
        parts = pdist.gather_to_main((owners, results, t["images"],
                                      t["groups"]))
        if not pdist.is_main():
            return pdist.broadcast_from_main(None)
        order = np.argsort(np.concatenate(
            [np.asarray(p[0], np.int64) for p in parts]), kind="stable")
        merged = [r for p in parts for r in p[1]]
        results = [merged[int(k)] for k in order]
        t["images"] = sum(p[2] for p in parts)
        t["groups"] = sum(p[3] for p in parts)

    res_folder = os.path.join(output_dir, "results")
    os.makedirs(res_folder, exist_ok=True)
    res_file = os.path.join(
        res_folder, f"keypoints_{dataset.image_set}_results_bu.json")
    with open(res_file, "w") as f:
        json.dump(results, f)

    if "test" in dataset.image_set:
        name_value, perf = OrderedDict([("Null", 0)]), 0
    else:
        t0 = time.perf_counter()
        eval_stats = COCOKeypointEval(dataset.ann_file, results).run()
        t["eval_s"] = time.perf_counter() - t0
        name_value = OrderedDict(zip(STATS_NAMES,
                                     [float(x) for x in eval_stats]))
        print_name_value(logger, name_value, cfg.MODEL.NAME)
        perf = name_value["AP"]
    logger.info("=> bottom-up pass: %d images, %d groups; device %.3f s, "
                "grouping %.3f s, COCO eval %.3f s", t["images"],
                t["groups"], t["device_s"], t["group_s"], t["eval_s"])
    if stats is not None:
        stats.update(t)
    if group is not None:
        return pdist.broadcast_from_main((name_value, perf))
    return name_value, perf
