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


def fliplr_joints(joints, joints_vis, width, matched_parts):
    """Horizontally flip joint coordinates and swap the left/right pairs
    (`lib/utils/transforms.py:44-58`, the final joints * joints_vis
    masking included)."""
    joints = joints.copy()
    joints_vis = joints_vis.copy()
    joints[:, 0] = width - joints[:, 0] - 1
    for a, b in matched_parts:
        joints[[a, b]] = joints[[b, a]]
        joints_vis[[a, b]] = joints_vis[[b, a]]
    return joints * joints_vis, joints_vis


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


def invert_affine(m: torch.Tensor) -> torch.Tensor:
    """Invert (..., 2, 3) affine matrices."""
    a, b, tx = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    c, d, ty = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    det = a * d - b * c
    ia, ib = d / det, -b / det
    ic, id_ = -c / det, a / det
    itx = -(ia * tx + ib * ty)
    ity = -(ic * tx + id_ * ty)
    return torch.stack([torch.stack([ia, ib, itx], -1),
                        torch.stack([ic, id_, ity], -1)], -2)


def warp_affine(images: torch.Tensor, mats: torch.Tensor, out_size,
                fill_value: float = 0.0) -> torch.Tensor:
    """Batched bilinear inverse warp of NHWC `images` (B, Hs, Ws, C), uint8
    or float, by the forward (src -> dst) matrices `mats` (B, 2, 3) to
    `out_size` (w, h): f32 (B, h, w, C). It equals cv2.warpAffine(
    INTER_LINEAR, BORDER_CONSTANT) up to cv2's fixed-point interpolation,
    and follows the JAX package's `warp_affine` rule for rule: floor of the
    source coordinate, the four neighbours gathered with out-of-image ones
    replaced by `fill_value`, x blended before y."""
    out_w, out_h = int(out_size[0]), int(out_size[1])
    b, hs, ws, c = images.shape
    inv = invert_affine(mats.to(torch.float32))  # dst -> src
    ys = torch.arange(out_h, dtype=torch.float32, device=images.device)
    xs = torch.arange(out_w, dtype=torch.float32, device=images.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")  # (out_h, out_w)

    def coef(i, j):
        return inv[:, i, j, None, None]

    sx = coef(0, 0) * gx + coef(0, 1) * gy + coef(0, 2)
    sy = coef(1, 0) * gx + coef(1, 1) * gy + coef(1, 2)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    wx, wy = (sx - x0)[..., None], (sy - y0)[..., None]
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
    flat = images.reshape(b, hs * ws, c)

    def gather(yi, xi):
        valid = (xi >= 0) & (xi < ws) & (yi >= 0) & (yi < hs)
        idx = yi.clamp(0, hs - 1) * ws + xi.clamp(0, ws - 1)
        vals = flat.gather(1, idx.view(b, -1, 1).expand(-1, -1, c))
        vals = vals.view(b, out_h, out_w, c).to(torch.float32)
        return torch.where(valid[..., None], vals, fill_value)

    v00 = gather(y0i, x0i)
    v01 = gather(y0i, x0i + 1)
    v10 = gather(y0i + 1, x0i)
    v11 = gather(y0i + 1, x0i + 1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


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
