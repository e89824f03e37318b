"""Heatmap target generation, decoding and PCK on NCHW tensors.

Port of `advmix_tpu/ops/heatmap.py`. Behavioural references:
- target generation: `lib/dataset/JointsDataset.py:412-491` (stride-quantized
  joint location with `int(x + 0.5)` truncation, unnormalized Gaussian on a
  (6*sigma+1)^2 window, weight zeroed when the window is out of bounds);
- decoding: `lib/core/inference.py:22-95`, and the soft-argmax variant
  of TEST.SOFT_ARGMAX, `lib/core/inference.py:97-162`;
- PCK: `lib/core/evaluate.py:16-99`, with its [h, w]/10 normalization.

Every argmax here takes the FIRST row-major maximum, as `np.argmax` does:
in bf16 the flip-averaged heatmaps take few distinct values, so ties are
common, and torch's CUDA argmax does not promise which index it returns.
"""

from __future__ import annotations

import torch

from .transforms import transform_preds_batch


# ---------------------------------------------------------------------------
# Target generation
# ---------------------------------------------------------------------------

def generate_target(joints: torch.Tensor, joints_vis: torch.Tensor,
                    image_size, heatmap_size, sigma: float):
    """Batched Gaussian heatmap targets.

    joints (B, J, 2) in crop-image space, joints_vis (B, J) 0/1. Returns
    target (B, J, Hh, Hw) f32, centers (B, J, 2) (0 where not pasted) and
    target_weight (B, J) f32."""
    hw, hh = int(heatmap_size[0]), int(heatmap_size[1])
    stride_x = float(image_size[0]) / hw
    stride_y = float(image_size[1]) / hh
    tmp_size = int(sigma * 3)

    # int(x + 0.5) truncates toward zero (Python int()), not floor
    mu_x = torch.trunc(joints[..., 0] / stride_x + 0.5).to(torch.int32)
    mu_y = torch.trunc(joints[..., 1] / stride_y + 0.5).to(torch.int32)

    out_of_bounds = ((mu_x - tmp_size >= hw) | (mu_y - tmp_size >= hh)
                     | (mu_x + tmp_size + 1 < 0) | (mu_y + tmp_size + 1 < 0))
    weight = joints_vis.to(torch.float32) * (~out_of_bounds)
    paste = weight > 0.5

    dev = joints.device
    dx = torch.arange(hw, dtype=torch.int32, device=dev) - mu_x[..., None]
    dy = torch.arange(hh, dtype=torch.int32, device=dev) - mu_y[..., None]
    gx = torch.exp(-(dx.to(torch.float32) ** 2) / (2.0 * sigma**2))
    gy = torch.exp(-(dy.to(torch.float32) ** 2) / (2.0 * sigma**2))
    # hard window: the reference pastes only a (2*tmp_size+1)^2 patch
    gx = torch.where(dx.abs() <= tmp_size, gx, 0.0)
    gy = torch.where(dy.abs() <= tmp_size, gy, 0.0)

    target = gy[:, :, :, None] * gx[:, :, None, :]
    target = target * paste[:, :, None, None]

    centers = torch.stack([mu_x.to(torch.float32), mu_y.to(torch.float32)], -1)
    return target, centers * paste[..., None], weight


# ---------------------------------------------------------------------------
# Decoding
# ---------------------------------------------------------------------------

def argmax_first(flat: torch.Tensor):
    """(max, index of its first occurrence) over the last axis."""
    m = flat.amax(dim=-1, keepdim=True)
    n = flat.shape[-1]
    iota = torch.arange(n, device=flat.device)
    idx = torch.where(flat == m, iota, n).amin(dim=-1)
    return m, idx


def get_max_preds(heatmaps: torch.Tensor):
    """Argmax decode of (B, J, H, W) heatmaps: preds (B, J, 2) as (x, y)
    f32 and maxvals (B, J, 1); coords zeroed where maxval <= 0
    (`lib/core/inference.py:45-48`)."""
    b, j, h, w = heatmaps.shape
    maxvals, idx = argmax_first(heatmaps.reshape(b, j, h * w))
    px = (idx % w).to(torch.float32)
    py = torch.div(idx, w, rounding_mode="floor").to(torch.float32)
    preds = torch.stack([px, py], dim=-1)
    return preds * (maxvals > 0.0).to(torch.float32), maxvals


def quarter_offset(heatmaps: torch.Tensor, coords: torch.Tensor):
    """POST_PROCESS quarter-pixel refinement (`lib/core/inference.py:63-76`):
    shift each coord 0.25 px toward the larger of its two axis neighbours,
    only when the rounded peak is strictly inside (1, size - 2)."""
    b, j, h, w = heatmaps.shape
    px = torch.floor(coords[..., 0] + 0.5).to(torch.int64)
    py = torch.floor(coords[..., 1] + 0.5).to(torch.int64)
    inside = (px > 1) & (px < w - 1) & (py > 1) & (py < h - 1)
    pxc = px.clamp(1, w - 2)
    pyc = py.clamp(1, h - 2)
    flat = heatmaps.reshape(b, j, h * w)

    def at(yy, xx):
        # off-map indices occur only where `inside` is false; clamp them
        # so the gather stays in bounds (the value is masked out below)
        i = (yy * w + xx).clamp(0, h * w - 1)
        return torch.gather(flat, 2, i[..., None])[..., 0]

    diff_x = at(pyc, pxc + 1) - at(pyc, pxc - 1)
    diff_y = at(pyc + 1, pxc) - at(pyc - 1, pxc)
    delta = torch.stack([torch.sign(diff_x), torch.sign(diff_y)], -1) * 0.25
    return coords + delta * inside[..., None].to(coords.dtype)


def get_final_preds(heatmaps: torch.Tensor, center: torch.Tensor,
                    scale: torch.Tensor, post_process: bool = True):
    """Argmax (+ quarter offset) then inverse affine to original-image
    coords (`lib/core/inference.py:52-95`). Returns preds (B, J, 2) and
    maxvals (B, J, 1)."""
    coords, maxvals = get_max_preds(heatmaps)
    if post_process:
        coords = quarter_offset(heatmaps, coords)
    h, w = heatmaps.shape[2], heatmaps.shape[3]
    return transform_preds_batch(coords, center, scale, (w, h)), maxvals


def soft_argmax(heatmaps: torch.Tensor, beta: float = 160.0):
    """Soft-argmax decode of (B, J, H, W) heatmaps (`SoftArgmax2D`,
    `lib/core/inference.py:97-131`, beta 160 at the call site): the
    expectation of the coordinate grid under softmax(beta * heatmap), in
    f32, and the heatmap's value at the rounded, clipped coordinate as the
    confidence. Returns preds (B, J, 2) as (x, y) and maxvals (B, J, 1)."""
    b, j, h, w = heatmaps.shape
    hm = heatmaps.to(torch.float32)
    probs = torch.softmax(hm.reshape(b, j, h * w) * beta, dim=-1)
    probs = probs.reshape(b, j, h, w)
    ys = torch.arange(h, dtype=torch.float32, device=hm.device)
    xs = torch.arange(w, dtype=torch.float32, device=hm.device)
    px = (probs * xs[None, None, None, :]).sum(dim=(2, 3))
    py = (probs * ys[None, None, :, None]).sum(dim=(2, 3))
    preds = torch.stack([px, py], dim=-1)
    # torch.round and jnp.round both round half to even
    ix = torch.round(px).to(torch.int64).clamp(0, w - 1)
    iy = torch.round(py).to(torch.int64).clamp(0, h - 1)
    maxvals = torch.gather(hm.reshape(b, j, h * w), 2, (iy * w + ix)[..., None])
    return preds, maxvals


def get_final_preds_softargmax(heatmaps: torch.Tensor, center: torch.Tensor,
                               scale: torch.Tensor, beta: float = 160.0,
                               post_process: bool = True):
    """Soft-argmax (+ quarter offset) then inverse affine to original-image
    coords (`lib/core/inference.py:129-162`). Returns preds (B, J, 2) and
    maxvals (B, J, 1)."""
    coords, maxvals = soft_argmax(heatmaps, beta)
    if post_process:
        coords = quarter_offset(heatmaps, coords)
    h, w = heatmaps.shape[2], heatmaps.shape[3]
    return transform_preds_batch(coords, center, scale, (w, h)), maxvals


# ---------------------------------------------------------------------------
# PCK accuracy
# ---------------------------------------------------------------------------

def pck_sums(output: torch.Tensor, target: torch.Tensor, thr: float = 0.5,
             sample_mask: torch.Tensor | None = None):
    """Per-joint (hit_count, valid_count) f32 sums for PCK on NCHW
    heatmaps. Distances are normalized by [h, w] / 10 (reference quirk:
    h scales x, w scales y); samples with target coords <= 1 and rows
    with sample_mask == 0 are ignored."""
    pred, _ = get_max_preds(output)
    tgt, _ = get_max_preds(target)
    h, w = output.shape[2], output.shape[3]
    # filled on the device, not copied from the host: a CUDA graph of the
    # AdvMix step captures this
    norm = torch.full((2,), h / 10.0, dtype=torch.float32,
                      device=output.device)
    norm[1:].fill_(w / 10.0)
    valid = (tgt[..., 0] > 1) & (tgt[..., 1] > 1)
    if sample_mask is not None:
        valid = valid & (sample_mask[:, None] > 0)
    d = torch.linalg.vector_norm((pred - tgt) / norm, dim=-1)
    hit = (d < thr) & valid
    return (hit.sum(0).to(torch.float32), valid.sum(0).to(torch.float32))


def pck_from_sums(hit_j: torch.Tensor, valid_j: torch.Tensor):
    """(per_joint (J,), avg, cnt) from per-joint hit/valid counts; per-joint
    accuracy is -1 where no valid sample exists."""
    per_joint = torch.where(valid_j > 0, hit_j / valid_j.clamp(min=1), -1.0)
    cnt = (valid_j > 0).sum()
    total = torch.where(per_joint >= 0, per_joint, 0.0).sum()
    avg = torch.where(cnt > 0, total / cnt.clamp(min=1), 0.0)
    return per_joint, avg, cnt
