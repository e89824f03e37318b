"""The top-down eval step.

Port of `advmix_tpu/engine/steps.py:make_eval_step` (reference
`lib/core/function.py:200-318`) for one device: flip test, `flip_back`,
the one-pixel shift, the per-sample loss and PCK sums with the padded-tail
`valid` mask, decode through the CUDA decode kernel
(`ops/cuda/decode_kernel.py`, the counterpart of the Pallas kernel the JAX
step uses on a TPU) and the device inverse affine. The JAX step's
`psum`s over replicas become plain sums here.

Boundary as in the JAX step: NHWC (B, H, W, 3) normalized images in,
coords (B, J, 2) and maxvals (B, J, 1) out. Inside, heatmaps are NCHW,
and targets come in NCHW (B, J, Hh, Hw) from `generate_target`.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..ops.cuda.decode_kernel import decode_heatmaps
from ..ops.heatmap import pck_from_sums, pck_sums
from ..ops.losses import joints_loss_per_sample, joints_ohkm_loss_per_sample
from ..ops.transforms import flip_back, shift_heatmap_right, \
    transform_preds_batch


def _per_sample_loss_fn_for(cfg):
    use_tw = cfg.LOSS.USE_TARGET_WEIGHT
    if cfg.LOSS.USE_OHKM:
        topk = cfg.LOSS.TOPK
        return lambda out, tgt, tw: joints_ohkm_loss_per_sample(
            out, tgt, tw, use_tw, topk)
    # LOSS.SMOOTH_L1 carries the reference's inverted meaning
    # (lib/core/loss.py:16-21): False -> SmoothL1, True -> MSE
    crit = "mse" if cfg.LOSS.SMOOTH_L1 else "smooth_l1"
    return lambda out, tgt, tw: joints_loss_per_sample(
        out, tgt, tw, use_tw, crit)


def make_eval_step(model, cfg, flip_pairs: Sequence):
    """Returns `step(batch) -> (preds, maxvals, metrics)` for an eval-mode
    model. `batch` holds device tensors: image (B, H, W, 3), target
    (B, J, Hh, Hw), target_weight (B, J), center (B, 2), scale (B, 2) and
    optionally valid (B,). `step.forward(image)` gives the flip-averaged
    f32 NCHW heatmaps that `step` decodes."""
    if cfg.TEST.SOFT_ARGMAX:
        raise NotImplementedError("TEST.SOFT_ARGMAX is not ported yet")
    loss_per_sample = _per_sample_loss_fn_for(cfg)
    flip_test = cfg.TEST.FLIP_TEST
    shift = cfg.TEST.SHIFT_HEATMAP
    post = cfg.TEST.POST_PROCESS
    pairs = tuple(tuple(p) for p in flip_pairs)

    @torch.no_grad()
    def forward(image):
        x = image.permute(0, 3, 1, 2)  # NHWC -> NCHW
        out = model(x)
        if flip_test:
            out_f = flip_back(model(x.flip(3)), pairs)
            if shift:
                out_f = shift_heatmap_right(out_f)
            out = (out + out_f) * 0.5
        return out.contiguous()

    @torch.no_grad()
    def step(batch):
        out = forward(batch["image"])
        valid = batch.get("valid")
        if valid is None:
            valid = torch.ones(out.shape[0], device=out.device)
        v = valid.to(torch.float32)
        # padded tail rows (the Loader repeats the last sample) are masked
        # out of the logged loss and PCK
        ps = loss_per_sample(out, batch["target"], batch["target_weight"])
        loss = (ps * v).sum() / v.sum().clamp(min=1.0)
        hit_j, val_j = pck_sums(out, batch["target"], sample_mask=v)
        _, acc, cnt = pck_from_sums(hit_j, val_j)
        coords, maxvals = decode_heatmaps(out, post_process=post)
        h, w = out.shape[2], out.shape[3]
        preds = transform_preds_batch(coords, batch["center"],
                                      batch["scale"], (w, h))
        metrics = {"loss": loss, "acc": acc, "acc_cnt": cnt,
                   "pck_hit_j": hit_j, "pck_valid_j": val_j}
        return preds, maxvals, metrics

    step.forward = forward
    return step
