"""Associative-embedding ops for bottom-up pose (HigherHRNet).

Port of `advmix_tpu/ops/ae.py` (Newell et al.'s associative embedding with
the 'exp' push loss, as HigherHRNet uses it): multi-person Gaussian
targets, the pull/push AE loss, the masked heatmap MSE, max-pool NMS with
per-joint top-k peaks, and the bilinear aggregation of the output scales.
The greedy grouping of the peaks runs on the host
(`evaluation/grouping.py`).

Layouts: maps are NCHW, as the model emits them. Where the JAX function
takes or returns an NHWC map (B, H, W, J), the port takes or returns
(B, J, H, W); a stacked tag map (B, H, W, J, T) becomes (B, J, H, W, T).
Joint coordinates (B, M, J, 2), visibilities (B, M, J) and the peak
tensors (B, J, k[, T]) keep the JAX layouts.

Resizes: `jax.image.resize(..., "linear")` antialiases when it downsamples
and is plain half-pixel bilinear when it upsamples; `resize_bilinear`
does the same with `F.interpolate`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """`jax.image.resize(x, ..., "linear")` of the last two axes of an
    (N, C, H, W) tensor to `size` (h, w): antialiased where either axis
    shrinks, plain bilinear (align_corners=False) otherwise."""
    h, w = int(size[0]), int(size[1])
    if (x.shape[-2], x.shape[-1]) == (h, w):
        return x
    shrink = h < x.shape[-2] or w < x.shape[-1]
    return F.interpolate(x, size=(h, w), mode="bilinear",
                         align_corners=False, antialias=shrink)


# ---------------------------------------------------------------------------
# targets
# ---------------------------------------------------------------------------

def generate_bottomup_target(joints: torch.Tensor, joints_vis: torch.Tensor,
                             heatmap_size, sigma: float):
    """Multi-person Gaussian heatmaps: per joint, the max over persons of
    the top-down generator's quantize-then-paste window (`ops/heatmap.py`).

    joints (B, M, J, 2) in heatmap coordinates, joints_vis (B, M, J),
    heatmap_size (w, h). Returns the target (B, J, Hh, Hw) in f32 (the JAX
    function's is NHWC) and the quantized int locations (B, M, J, 2),
    zero where a joint is not pasted."""
    hw, hh = int(heatmap_size[0]), int(heatmap_size[1])
    tmp_size = int(sigma * 3)
    mu_x = torch.trunc(joints[..., 0] + 0.5).to(torch.int32)  # (B, M, J)
    mu_y = torch.trunc(joints[..., 1] + 0.5).to(torch.int32)
    in_bounds = ((mu_x - tmp_size < hw) & (mu_y - tmp_size < hh)
                 & (mu_x + tmp_size + 1 >= 0) & (mu_y + tmp_size + 1 >= 0))
    paste = (joints_vis > 0.5) & in_bounds  # (B, M, J)

    dev = joints.device
    xs = torch.arange(hw, dtype=torch.int32, device=dev)
    ys = torch.arange(hh, dtype=torch.int32, device=dev)
    dx = xs - mu_x[..., None]  # (B, M, J, Hw)
    dy = ys - mu_y[..., None]  # (B, M, J, Hh)
    gx = torch.exp(-(dx.to(torch.float32) ** 2) / (2.0 * sigma ** 2))
    gy = torch.exp(-(dy.to(torch.float32) ** 2) / (2.0 * sigma ** 2))
    gx = torch.where(dx.abs() <= tmp_size, gx, 0.0)
    gy = torch.where(dy.abs() <= tmp_size, gy, 0.0)
    g = gy[..., :, None] * gx[..., None, :]  # (B, M, J, Hh, Hw)
    g = g * paste[..., None, None]
    target = g.amax(dim=1)  # max over persons -> (B, J, Hh, Hw)
    locs = torch.stack([mu_x, mu_y], dim=-1) * paste[..., None]
    return target, locs


# ---------------------------------------------------------------------------
# AE loss
# ---------------------------------------------------------------------------

def ae_loss(tags: torch.Tensor, joint_locs: torch.Tensor,
            joints_vis: torch.Tensor):
    """Returns (pull, push), each a scalar mean over the batch.

    tags (B, J, H, W) tagmaps (tag_per_joint), joint_locs (B, M, J, 2) int
    locations in tagmap space, joints_vis (B, M, J) 0/1. A person's
    reference tag is the mean of its visible joints' tags; pull is the
    squared deviation from it, push exp(-(h_n - h_m)^2) over person pairs
    (halved, as published)."""
    b, j, h, w = tags.shape
    m = joint_locs.shape[1]
    x = joint_locs[..., 0].clamp(0, w - 1).long()
    y = joint_locs[..., 1].clamp(0, h - 1).long()
    flat = tags.reshape(b, j, h * w)
    idx = (y * w + x).transpose(1, 2)  # (B, J, M)
    t = torch.gather(flat, 2, idx).transpose(1, 2)  # (B, M, J)

    vis = joints_vis.to(t.dtype)
    n_vis = vis.sum(dim=2)  # (B, M)
    person_valid = n_vis > 0
    href = (t * vis).sum(dim=2) / n_vis.clamp(min=1.0)  # (B, M)

    dev = ((t - href[:, :, None]) ** 2 * vis).sum(dim=2)
    per_person = dev / n_vis.clamp(min=1.0)
    k = person_valid.sum(dim=1).to(t.dtype)  # (B,)
    pull = (per_person * person_valid).sum(dim=1) / k.clamp(min=1.0)

    pv = person_valid.to(t.dtype)
    pair_valid = pv[:, :, None] * pv[:, None, :]
    eye = torch.eye(m, dtype=t.dtype, device=t.device)[None]
    diff = href[:, :, None] - href[:, None, :]
    e = torch.exp(-(diff ** 2)) * pair_valid * (1.0 - eye)
    denom = (k * (k - 1)).clamp(min=1.0)
    push = e.sum(dim=(1, 2)) / denom * 0.5
    push = torch.where(k > 1, push, torch.zeros_like(push))
    return pull.mean(), push.mean()


def bottomup_heatmap_loss(pred: torch.Tensor, target: torch.Tensor,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """Per-pixel MSE of (B, J, H, W) maps with an optional (B, H, W) valid
    mask (1 = supervise)."""
    d = (pred - target) ** 2
    if mask is not None:
        d = d * mask[:, None]
    return d.mean()


# ---------------------------------------------------------------------------
# peak extraction (device)
# ---------------------------------------------------------------------------

def top_k_peaks(heatmaps: torch.Tensor, tags: torch.Tensor, k: int = 30):
    """Max-pool NMS, then the k largest survivors per joint.

    heatmaps (B, J, H, W); tags (B, J, H, W) scalar tagmaps or
    (B, J, H, W, T) stacked tag vectors (the flip test's T=2). Returns a
    dict of (B, J, k) tensors x, y, val; tag is (B, J, k) or (B, J, k, T).
    Among equal values the lower flat index comes first, as in
    `lax.top_k` (a stable descending sort: after the NMS most of a map is
    exact 0). Run it on f32 maps: in bf16 the `pooled == heatmaps` test
    ties neighbours and drops peaks."""
    b, j, h, w = heatmaps.shape
    pooled = F.max_pool2d(heatmaps, 3, stride=1, padding=1)
    keep = torch.where(pooled == heatmaps, heatmaps,
                       torch.zeros_like(heatmaps))
    flat = keep.reshape(b, j, h * w)
    vals, idx = torch.sort(flat, dim=2, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    xs = (idx % w).to(heatmaps.dtype)
    ys = torch.div(idx, w, rounding_mode="floor").to(heatmaps.dtype)
    if tags.dim() == 5:
        t = tags.shape[-1]
        tflat = tags.reshape(b, j, h * w, t)
        tvals = torch.gather(tflat, 2, idx[..., None].expand(b, j, k, t))
    else:
        tvals = torch.gather(tags.reshape(b, j, h * w), 2, idx)
    return {"x": xs, "y": ys, "val": vals, "tag": tvals}


def aggregate_heatmaps(outputs, target_hw):
    """Average the heatmaps of every output scale at `target_hw` (bilinear)
    and resize the tagmap there. outputs: NCHW maps, outputs[0] carrying J
    heatmaps + the tags, outputs[1:] J heatmaps. Returns (heat (B, J, h, w),
    tags (B, T, h, w))."""
    num_j = outputs[-1].shape[1]
    heat = [resize_bilinear(o[:, :num_j], target_hw) for o in outputs]
    heat_avg = sum(heat) / len(heat)
    tags_up = resize_bilinear(outputs[0][:, num_j:], target_hw)
    return heat_avg, tags_up
