"""Debug-image dumps.

The port's copy of `advmix_tpu/utils/vis.py` (reference
`lib/utils/vis.py:22-187`): joint-overlay grids and per-joint heatmap
grids, gated by the DEBUG.* flags, which the trainer writes every
PRINT_FREQ batches. Host numpy and cv2 on NHWC arrays (images in [0, 255]
or normalized; heatmaps (B, Hh, Hw, J)), with the JAX package's arithmetic,
so that the same inputs give the same bytes. `cv2` is imported at the first
dump, and a missing cv2 raises there.
"""

from __future__ import annotations

import math
import os

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32) * 255.0
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32) * 255.0


def denormalize(images: np.ndarray) -> np.ndarray:
    """Undo torchvision-style normalization back to uint8 RGB."""
    x = images * IMAGENET_STD + IMAGENET_MEAN
    return np.clip(x, 0, 255).astype(np.uint8)


def save_batch_image_with_joints(
    images: np.ndarray,  # (B, H, W, 3) uint8
    joints: np.ndarray,  # (B, J, 2)
    joints_vis: np.ndarray,  # (B, J)
    file_name: str,
    nrow: int = 8,
    padding: int = 2,
):
    import cv2

    b, h, w, _ = images.shape
    xmaps = min(nrow, b)
    ymaps = int(math.ceil(b / xmaps))
    grid = np.zeros((ymaps * (h + padding), xmaps * (w + padding), 3),
                    np.uint8)
    k = 0
    for y in range(ymaps):
        for x in range(xmaps):
            if k >= b:
                break
            img = images[k].copy()
            for j in range(joints.shape[1]):
                if joints_vis[k, j] > 0:
                    cv2.circle(img, (int(joints[k, j, 0]),
                                     int(joints[k, j, 1])),
                               2, [255, 0, 0], 2)
            grid[y * (h + padding): y * (h + padding) + h,
                 x * (w + padding): x * (w + padding) + w] = img
            k += 1
    cv2.imwrite(file_name, cv2.cvtColor(grid, cv2.COLOR_RGB2BGR))


def save_batch_heatmaps(
    images: np.ndarray,  # (B, H, W, 3) uint8
    heatmaps: np.ndarray,  # (B, Hh, Hw, J)
    file_name: str,
):
    import cv2

    b, hh, hw, j = heatmaps.shape
    grid = np.zeros((b * hh, (j + 1) * hw, 3), np.uint8)
    # cv2.applyColorMap of a uint8 map is a lookup in a 256-entry table:
    # one call makes the table, the maps index it (a call per map made the
    # dumps of a batch of 128 take 57 s with cv2 4.13 on the host of an
    # NVIDIA H100 80GB HBM3 at 700 W; PERF.md)
    jet = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None],
                            cv2.COLORMAP_JET)[:, 0]
    for i in range(b):
        img = cv2.resize(images[i], (hw, hh))
        hm = heatmaps[i]
        row = grid[i * hh: (i + 1) * hh]
        row[:, :hw] = img
        for jj in range(j):
            m = np.clip(hm[:, :, jj] * 255, 0, 255).astype(np.uint8)
            colored = jet[m]
            blend = (colored * 0.7 + img * 0.3).astype(np.uint8)
            row[:, (jj + 1) * hw: (jj + 2) * hw] = blend
    cv2.imwrite(file_name, cv2.cvtColor(grid, cv2.COLOR_RGB2BGR))


def save_debug_images(
    cfg,
    images_norm: np.ndarray,  # normalized NHWC batch
    joints: np.ndarray,
    joints_vis: np.ndarray,
    target_heatmaps: np.ndarray,
    pred_joints: np.ndarray,
    output_heatmaps: np.ndarray,
    prefix: str,
):
    """The dump set that DEBUG.* selects (`lib/utils/vis.py:149-187`):
    `<prefix>_gt.jpg`, `_pred.jpg`, `_hm_gt.jpg`, `_hm_pred.jpg`."""
    if not cfg.DEBUG.DEBUG:
        return
    images = denormalize(np.asarray(images_norm))
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
    if cfg.DEBUG.SAVE_BATCH_IMAGES_GT:
        save_batch_image_with_joints(images, joints, joints_vis,
                                     f"{prefix}_gt.jpg")
    if cfg.DEBUG.SAVE_BATCH_IMAGES_PRED:
        save_batch_image_with_joints(images, pred_joints,
                                     np.ones_like(joints_vis),
                                     f"{prefix}_pred.jpg")
    if cfg.DEBUG.SAVE_HEATMAPS_GT:
        save_batch_heatmaps(images, np.asarray(target_heatmaps),
                            f"{prefix}_hm_gt.jpg")
    if cfg.DEBUG.SAVE_HEATMAPS_PRED:
        save_batch_heatmaps(images, np.asarray(output_heatmaps),
                            f"{prefix}_hm_pred.jpg")
