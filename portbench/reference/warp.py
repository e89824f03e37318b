"""Batched bilinear inverse warp, a frozen copy of the measured program's
`ops/transforms.warp_affine`, used by the reference corruptions."""

from __future__ import annotations

import torch


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
