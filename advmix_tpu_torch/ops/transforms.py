"""Geometric transforms: affine construction, prediction back-projection
and the flip-test helpers.

Port of `advmix_tpu/ops/transforms.py` (reference
`lib/utils/transforms.py:16-133`). The host helpers are numpy, with exact
cv2.getAffineTransform parity; the batched versions are torch on the
device. Heatmaps are NCHW `(B, J, H, W)` throughout the port.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PIXEL_STD = 200.0


# ---------------------------------------------------------------------------
# Host-side (numpy) affine construction
# ---------------------------------------------------------------------------

def _rotate_point(pt, rot_rad):
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    return np.array(
        [pt[0] * cs - pt[1] * sn, pt[0] * sn + pt[1] * cs], dtype=np.float32
    )


def _third_point(a, b):
    # Complete the right triangle: b + perp(a - b), perp([x,y]) = [-y, x].
    d = a - b
    return b + np.array([-d[1], d[0]], dtype=np.float32)


def _solve_affine(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """2x3 affine M with M @ [x, y, 1]^T = dst for each of 3 point pairs
    (the linear system cv2.getAffineTransform solves)."""
    x = np.concatenate([src.astype(np.float64), np.ones((3, 1))], axis=1)
    m = np.linalg.solve(x, dst.astype(np.float64))  # (3, 2)
    return m.T  # (2, 3)


def get_affine_transform(center, scale, rot, output_size, shift=(0.0, 0.0),
                         inv: bool = False) -> np.ndarray:
    """Crop transform from (center, scale[, rot]) to output_size [w, h].

    `scale` is in units of PIXEL_STD (200) pixels
    (`lib/utils/transforms.py:77`). Returns a float64 (2, 3) matrix."""
    center = np.asarray(center, dtype=np.float32)
    scale = np.asarray(scale, dtype=np.float32)
    if scale.ndim == 0:
        scale = np.array([scale, scale], dtype=np.float32)
    shift = np.asarray(shift, dtype=np.float32)

    scale_tmp = scale * PIXEL_STD
    src_w = scale_tmp[0]
    dst_w, dst_h = float(output_size[0]), float(output_size[1])

    rot_rad = np.pi * float(rot) / 180.0
    src_dir = _rotate_point(np.array([0.0, src_w * -0.5], np.float32), rot_rad)
    dst_dir = np.array([0.0, dst_w * -0.5], np.float32)

    src = np.zeros((3, 2), dtype=np.float32)
    dst = np.zeros((3, 2), dtype=np.float32)
    src[0] = center + scale_tmp * shift
    src[1] = center + src_dir + scale_tmp * shift
    dst[0] = [dst_w * 0.5, dst_h * 0.5]
    dst[1] = dst[0] + dst_dir
    src[2] = _third_point(src[0], src[1])
    dst[2] = _third_point(dst[0], dst[1])

    if inv:
        return _solve_affine(dst, src)
    return _solve_affine(src, dst)


def affine_transform(pt, t) -> np.ndarray:
    """Apply a 2x3 affine to a single (x, y) point (host side)."""
    p = np.array([pt[0], pt[1], 1.0])
    return (t @ p)[:2]


def transform_preds(coords, center, scale, output_size) -> np.ndarray:
    """Map (J, 2) heatmap-space coords back to original-image coords."""
    trans = get_affine_transform(center, scale, 0, output_size, inv=True)
    ones = np.ones((coords.shape[0], 1))
    homog = np.concatenate([coords[:, :2], ones], axis=1)
    return homog @ trans.T


# ---------------------------------------------------------------------------
# Device-side (torch) batched versions
# ---------------------------------------------------------------------------

def get_affine_transform_batch(center: torch.Tensor, scale: torch.Tensor,
                               rot: torch.Tensor, output_size,
                               inv: bool = False) -> torch.Tensor:
    """Batched affine construction on the tensors' device: (B, 2, 3) f32.

    The 3-point construction always defines a similarity transform, so
    this is the closed form A = (dst_w / src_w) * R(-rot),
    t = dst_center - A @ src_center (the generic 3x3 solve is
    ill-conditioned in f32 for large pixel coordinates)."""
    dst_w, dst_h = float(output_size[0]), float(output_size[1])
    src_w = scale[:, 0] * PIXEL_STD
    rot_rad = rot * (math.pi / 180.0)
    sn, cs = torch.sin(rot_rad), torch.cos(rot_rad)
    k = dst_w / src_w

    dst0_x = torch.full_like(k, dst_w * 0.5)
    dst0_y = torch.full_like(k, dst_h * 0.5)
    cx, cy = center[:, 0], center[:, 1]

    if inv:
        # inverse similarity: A' = (1/k) * R(rot), t' = src0 - A' @ dst0
        i00, i01 = cs / k, -sn / k
        i10, i11 = sn / k, cs / k
        tx = cx - (i00 * dst0_x + i01 * dst0_y)
        ty = cy - (i10 * dst0_x + i11 * dst0_y)
        return torch.stack([torch.stack([i00, i01, tx], -1),
                            torch.stack([i10, i11, ty], -1)], -2)

    a00, a01 = k * cs, k * sn
    a10, a11 = -k * sn, k * cs
    tx = dst0_x - (a00 * cx + a01 * cy)
    ty = dst0_y - (a10 * cx + a11 * cy)
    return torch.stack([torch.stack([a00, a01, tx], -1),
                        torch.stack([a10, a11, ty], -1)], -2)


def affine_transform_points(pts: torch.Tensor,
                            mats: torch.Tensor) -> torch.Tensor:
    """Apply (..., 2, 3) affine matrices to (..., 2) points."""
    x = mats[..., 0, 0] * pts[..., 0] + mats[..., 0, 1] * pts[..., 1] \
        + mats[..., 0, 2]
    y = mats[..., 1, 0] * pts[..., 0] + mats[..., 1, 1] * pts[..., 1] \
        + mats[..., 1, 2]
    return torch.stack([x, y], dim=-1)


def transform_preds_batch(coords: torch.Tensor, center: torch.Tensor,
                          scale: torch.Tensor, output_size) -> torch.Tensor:
    """(B, J, 2) heatmap-space coords -> original-image coords, on the
    device (`lib/utils/transforms.py:61` batched)."""
    rot = torch.zeros(center.shape[0], dtype=torch.float32,
                      device=center.device)
    inv = get_affine_transform_batch(center, scale, rot, output_size, inv=True)
    return affine_transform_points(coords, inv[:, None, :, :])


def flip_back(heatmaps: torch.Tensor, flip_pairs) -> torch.Tensor:
    """Undo a horizontal-flip pass on NCHW heatmaps (B, J, H, W): flip W
    and swap the left/right joint channels (`lib/utils/transforms.py:16-41`)."""
    perm = list(range(heatmaps.shape[1]))
    for a, b in flip_pairs:
        perm[a], perm[b] = perm[b], perm[a]
    return heatmaps.flip(3)[:, perm]


def shift_heatmap_right(heatmaps: torch.Tensor) -> torch.Tensor:
    """TEST.SHIFT_HEATMAP: 1px right shift on the W axis (NCHW); column 0
    keeps its value (`lib/core/function.py:258-260`)."""
    return torch.cat([heatmaps[..., :1], heatmaps[..., :-1]], dim=3)
