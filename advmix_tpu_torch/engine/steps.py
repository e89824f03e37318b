"""The top-down train, AdvMix and eval steps.

Port of `advmix_tpu/engine/steps.py` for one device. The JAX steps are
functions `state -> state` compiled under `shard_map`; here a step mutates
the state's modules and optimizers, and the `pmean`/`psum` over the data
axis have no counterpart on one card and are left out.

- standard step (`lib/core/function.py:30-95`): forward, loss, backward,
  optimizer step, PCK on the device.
- AdvMix step (`train_advmix`, `lib/core/function.py:107-197`): G forward
  and the softmax mix, the D update on the detached mix with the KD-teacher
  term, then the G update through the saved mix with the updated D in train
  mode, so D's BatchNorm running statistics update twice per iteration.
- eval step (`lib/core/function.py:200-318`): flip test, `flip_back`,
the one-pixel shift, the per-sample loss and PCK sums with the padded-tail
`valid` mask, decode through the CUDA decode kernel
(`ops/cuda/decode_kernel.py`, the counterpart of the Pallas kernel the JAX
step uses on a TPU) and the device inverse affine. The JAX step's
`psum`s over replicas become plain sums here.

Boundary of the eval step as in the JAX step: NHWC (B, H, W, 3) normalized
images in, coords (B, J, 2) and maxvals (B, J, 1) out. The train steps take
NCHW images (B, 3, H, W) or views (B, 9, H, W), as the train preprocessor
makes them. Heatmaps are NCHW, and targets come in NCHW (B, J, Hh, Hw) from
`generate_target`.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..ops.cuda.decode_kernel import decode_heatmaps
from ..ops.heatmap import pck_from_sums, pck_sums
from ..ops.losses import joints_loss, joints_loss_per_sample, \
    joints_ohkm_loss, joints_ohkm_loss_per_sample
from ..ops.transforms import flip_back, shift_heatmap_right, \
    transform_preds_batch


def _criterion_kind(cfg) -> str:
    # LOSS.SMOOTH_L1 carries the reference's inverted meaning
    # (lib/core/loss.py:16-21): False -> SmoothL1, True -> MSE
    return "mse" if cfg.LOSS.SMOOTH_L1 else "smooth_l1"


def _loss_fn_for(cfg):
    use_tw = cfg.LOSS.USE_TARGET_WEIGHT
    if cfg.LOSS.USE_OHKM:
        topk = cfg.LOSS.TOPK
        return lambda out, tgt, tw: joints_ohkm_loss(out, tgt, tw, use_tw,
                                                     topk)
    crit = _criterion_kind(cfg)
    return lambda out, tgt, tw: joints_loss(out, tgt, tw, use_tw, crit)


def _per_sample_loss_fn_for(cfg):
    use_tw = cfg.LOSS.USE_TARGET_WEIGHT
    if cfg.LOSS.USE_OHKM:
        topk = cfg.LOSS.TOPK
        return lambda out, tgt, tw: joints_ohkm_loss_per_sample(
            out, tgt, tw, use_tw, topk)
    crit = _criterion_kind(cfg)
    return lambda out, tgt, tw: joints_loss_per_sample(
        out, tgt, tw, use_tw, crit)


def _pck(out, target):
    with torch.no_grad():
        hit_j, val_j = pck_sums(out, target)
        _, acc, cnt = pck_from_sums(hit_j, val_j)
    return acc, cnt


# ---------------------------------------------------------------------------
# Standard training step (lib/core/function.py:30-95)
# ---------------------------------------------------------------------------

def make_train_step(state, cfg):
    """Returns `step(batch) -> metrics` that trains `state.model` on
    batch["image"] (B, 3, H, W) against batch["target"] and
    batch["target_weight"]. Metrics are device tensors: loss, acc,
    acc_cnt."""
    loss_of = _loss_fn_for(cfg)
    model, opt = state.model, state.optimizer

    def step(batch):
        model.train()
        opt.zero_grad(set_to_none=True)
        out = model(batch["image"])
        loss = loss_of(out, batch["target"], batch["target_weight"])
        loss.backward()
        opt.step()
        state.step += 1
        acc, cnt = _pck(out, batch["target"])
        return {"loss": loss.detach(), "acc": acc, "acc_cnt": cnt}

    return step


# ---------------------------------------------------------------------------
# AdvMix min-max step (lib/core/function.py:107-197)
# ---------------------------------------------------------------------------

def mix_views(logits: torch.Tensor, views: torch.Tensor,
              num_views: int = 3):
    """Softmax over the K logits per pixel, then the weighted sum of the K
    views (B, 3K, H, W). Returns (mixed, weights); the weights are f32, so
    the mix is f32 even for bf16 views."""
    w = torch.softmax(logits, dim=1)  # (B, K, H, W)
    mixed = None
    for k in range(num_views):
        term = views[:, 3 * k: 3 * k + 3] * w[:, k: k + 1]
        mixed = term if mixed is None else mixed + term
    return mixed, w


def make_advmix_step(state, cfg, alpha: float = 0.1,
                     adv_loss_weight: float = 1.0, num_views: int = 3,
                     _mutation=None):
    """Returns `step(batch) -> metrics` for one min-max iteration on
    batch["views"] (B, 3K, H, W), channel-concat of K normalized views with
    the clean one first. Metrics are device tensors: loss_d, loss_g, acc,
    acc_cnt (PCK of the G step's D output, `function.py:167-171`).
    `step.last_mix_weights` keeps the last iteration's mixing weights.

    `_mutation` is fault injection for the tests only: it plants the two
    faults of sequencing that this formulation could hide, so that the
    differential against the JAX step can show it would catch them.
    "single_bn_update" drops the G step's update of D's BN statistics
    (`function.py:160` runs D in train mode a second time);
    "stale_d_in_g_step" lets the G step see D as it was before its update
    (`function.py:155` steps the optimizer before the G forward)."""
    assert _mutation in (None, "single_bn_update", "stale_d_in_g_step")
    loss_of = _loss_fn_for(cfg)
    d, g, teacher = state.model_d, state.model_g, state.teacher
    opt_d, opt_g = state.optimizer_d, state.optimizer_g

    def step(batch):
        views = batch["views"]
        clean = views[:, :3]
        target, tw = batch["target"], batch["target_weight"]
        d.train()
        g.train()

        # G runs once, and its graph is kept: the G update goes back
        # through this same mix, whose weights were computed before D's
        # update (function.py:137-144)
        mixed, w = mix_views(g(views), views, num_views)
        step.last_mix_weights = w.detach()

        # the teacher, in eval mode, on the clean view (function.py:148-149)
        with torch.no_grad():
            teacher_out = teacher(clean)

        stale = None
        if _mutation == "stale_d_in_g_step":
            stale = {k: v.detach().clone() for k, v in d.state_dict().items()}

        # ---- D update on the detached mix (function.py:146-155) ----
        opt_d.zero_grad(set_to_none=True)
        out = d(mixed.detach())
        loss_d = (loss_of(out, target, tw) * (1.0 - alpha)
                  + loss_of(out, teacher_out, tw) * alpha)
        loss_d.backward()
        opt_d.step()
        del out  # D's first graph is freed before the second is built

        # ---- G update (function.py:158-164) ----
        # D is frozen for this step but has its updated parameters and
        # runs in train mode again: its BN statistics update a second time
        mixed_in = mixed.detach().requires_grad_(True)
        if _mutation == "single_bn_update":
            kept = {k: v.clone() for k, v in d.named_buffers()}
        if stale is not None:
            out_g = torch.func.functional_call(d, stale, (mixed_in,))
        else:
            out_g = d(mixed_in)
        loss_g = -loss_of(out_g, target, tw) * adv_loss_weight
        # the gradient reaches G only through the saved mix, and none of
        # it lands in D's .grad
        (dmixed,) = torch.autograd.grad(loss_g, mixed_in)
        opt_g.zero_grad(set_to_none=True)
        mixed.backward(dmixed)
        opt_g.step()
        with torch.no_grad():
            if _mutation == "single_bn_update":
                for k, v in d.named_buffers():
                    v.copy_(kept[k])
            elif stale is not None:
                for k, v in d.named_buffers():
                    v.copy_(stale[k])

        state.step += 1
        acc, cnt = _pck(out_g, target)
        return {"loss_d": loss_d.detach(), "loss_g": loss_g.detach(),
                "acc": acc, "acc_cnt": cnt}

    step.last_mix_weights = None
    return step


# ---------------------------------------------------------------------------
# Eval step (lib/core/function.py:200-318)
# ---------------------------------------------------------------------------

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
