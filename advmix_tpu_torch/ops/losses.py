"""Pose losses on NCHW heatmaps: batch means for training, per-sample
values for the eval metrics.

Port of `advmix_tpu/ops/losses.py` (reference `lib/core/loss.py`). The
reference's `JointsMSELoss` flag is inverted (`lib/core/loss.py:16-21`):
`LOSS.SMOOTH_L1: false` (the default) selects SmoothL1 (beta 1) and `true`
selects MSE; the config keeps that meaning.
"""

from __future__ import annotations

import torch


def smooth_l1(x: torch.Tensor) -> torch.Tensor:
    """Elementwise SmoothL1 (Huber, beta=1): 0.5x^2 if |x|<1 else |x|-0.5."""
    ax = x.abs()
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def _weighted(output, target, target_weight, use_target_weight):
    b, j = output.shape[:2]
    pred = output.reshape(b, j, -1)
    gt = target.reshape(b, j, -1)
    if use_target_weight:
        w = target_weight[:, :, None]
        pred = pred * w
        gt = gt * w
    return pred, gt


def joints_loss_per_sample(output: torch.Tensor, target: torch.Tensor,
                           target_weight: torch.Tensor,
                           use_target_weight: bool = True,
                           criterion: str = "smooth_l1") -> torch.Tensor:
    """(B,) losses whose mean is the reference JointsMSELoss: 0.5 * the
    per-joint mean criterion, averaged over joints (`lib/core/loss.py:46-65`)."""
    pred, gt = _weighted(output, target, target_weight, use_target_weight)
    diff = pred - gt
    per_elem = diff * diff if criterion == "mse" else smooth_l1(diff)
    per_sj = per_elem.mean(dim=2)  # (B, J)
    return 0.5 * per_sj.sum(dim=1) / output.shape[1]


def joints_ohkm_loss_per_sample(output: torch.Tensor, target: torch.Tensor,
                                target_weight: torch.Tensor,
                                use_target_weight: bool = True,
                                topk: int = 8) -> torch.Tensor:
    """(B,) online hard-keypoint-mining MSE (`lib/core/loss.py:68-110`):
    per-(sample, joint) 0.5*MSE, mean of the top-k hardest joints."""
    pred, gt = _weighted(output, target, target_weight, use_target_weight)
    per_joint = 0.5 * ((pred - gt) ** 2).mean(dim=2)
    topk_vals = torch.sort(per_joint, dim=1).values[:, -topk:]
    return topk_vals.sum(dim=1) / topk


def joints_loss(output: torch.Tensor, target: torch.Tensor,
                target_weight: torch.Tensor, use_target_weight: bool = True,
                criterion: str = "smooth_l1") -> torch.Tensor:
    """JointsMSELoss: 0.5 * the criterion's mean over (batch, pixels) per
    joint, averaged over joints (`lib/core/loss.py:46-65`)."""
    pred, gt = _weighted(output, target, target_weight, use_target_weight)
    diff = pred - gt
    per_elem = diff * diff if criterion == "mse" else smooth_l1(diff)
    per_joint = per_elem.mean(dim=(0, 2))  # (J,)
    return 0.5 * per_joint.sum() / output.shape[1]


def joints_ohkm_loss(output: torch.Tensor, target: torch.Tensor,
                     target_weight: torch.Tensor,
                     use_target_weight: bool = True,
                     topk: int = 8) -> torch.Tensor:
    """Batch mean of `joints_ohkm_loss_per_sample`."""
    return joints_ohkm_loss_per_sample(output, target, target_weight,
                                       use_target_weight, topk).mean()
