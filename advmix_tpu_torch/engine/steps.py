"""The train, AdvMix and eval steps, top-down and bottom-up.

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
step uses on a TPU) or, under TEST.SOFT_ARGMAX, the soft-argmax
(`ops/heatmap.py`; the decode kernel does not run), and the device inverse
affine. The JAX step's `psum`s over replicas become plain sums here.

With `debug=True` each step also returns `heatmap_debug.debug_outputs` of
its heatmaps (and the AdvMix step the mix), device tensors that the trainer
reads back only on the batches it dumps (`lib/core/function.py:92-95,
194-197, 301-316`).

The bottom-up (HigherHRNet) steps follow the public HigherHRNet recipe
(`steps.py:433-772`): per output scale a heatmap MSE masked by the
crowd/unannotated valid mask resized to that scale (`_mask_at`), plus the
AE pull/push at the 1/4 tag head; the AdvMix form adds the masked KD term
against the teacher's heatmaps. Their eval step (`bottomup_infer_fn`)
returns the flip-averaged heatmaps aggregated at the 1/2 resolution, the
tags and the top-k peaks, for host grouping.

Boundary of the eval step as in the JAX step: NHWC (B, H, W, 3) normalized
images in, coords (B, J, 2) and maxvals (B, J, 1) out. The train steps take
NCHW images (B, 3, H, W) or views (B, 9, H, W), as the train preprocessor
makes them. Heatmaps are NCHW, and targets come in NCHW (B, J, Hh, Hw) from
`generate_target`.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..ops.ae import ae_loss, aggregate_heatmaps, bottomup_heatmap_loss, \
    generate_bottomup_target, resize_bilinear, top_k_peaks
from ..ops.cuda.decode_kernel import decode_heatmaps
from ..ops.heatmap import get_final_preds_softargmax, pck_from_sums, \
    pck_sums
from ..ops.losses import joints_loss, joints_loss_per_sample, \
    joints_ohkm_loss, joints_ohkm_loss_per_sample
from ..ops.transforms import flip_back, shift_heatmap_right, \
    transform_preds_batch
from .heatmap_debug import debug_outputs


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

def make_train_step(state, cfg, debug: bool = False):
    """Returns `step(batch) -> metrics` that trains `state.model` on
    batch["image"] (B, 3, H, W) against batch["target"] and
    batch["target_weight"]. Metrics are device tensors: loss, acc,
    acc_cnt. With `debug`, `step(batch) -> (metrics, debug_outputs)`."""
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
        metrics = {"loss": loss.detach(), "acc": acc, "acc_cnt": cnt}
        if debug:
            return metrics, debug_outputs(out)
        return metrics

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
                     debug: bool = False, _mutation=None):
    """Returns `step(batch) -> metrics` for one min-max iteration on
    batch["views"] (B, 3K, H, W), channel-concat of K normalized views with
    the clean one first. Metrics are device tensors: loss_d, loss_g, acc,
    acc_cnt (PCK of the G step's D output, `function.py:167-171`).
    `step.last_mix_weights` keeps the last iteration's mixing weights. With
    `debug`, `step(batch) -> (metrics, debug_outputs)` of the G step's D
    output, with the detached mix under "mixed".

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
        metrics = {"loss_d": loss_d.detach(), "loss_g": loss_g.detach(),
                   "acc": acc, "acc_cnt": cnt}
        if debug:
            dbg = debug_outputs(out_g)
            dbg["mixed"] = mixed.detach()  # the adversarial mix, for dumps
            return metrics, dbg
        return metrics

    step.last_mix_weights = None
    return step


# ---------------------------------------------------------------------------
# Eval step (lib/core/function.py:200-318)
# ---------------------------------------------------------------------------

def make_eval_step(model, cfg, flip_pairs: Sequence, debug: bool = False):
    """Returns `step(batch) -> (preds, maxvals, metrics)` for an eval-mode
    model. `batch` holds device tensors: image (B, H, W, 3), target
    (B, J, Hh, Hw), target_weight (B, J), center (B, 2), scale (B, 2) and
    optionally valid (B,). `step.forward(image)` gives the flip-averaged
    f32 NCHW heatmaps that `step` decodes. With `debug` the step returns
    `debug_outputs` of those heatmaps as a fourth item."""
    loss_per_sample = _per_sample_loss_fn_for(cfg)
    flip_test = cfg.TEST.FLIP_TEST
    shift = cfg.TEST.SHIFT_HEATMAP
    post = cfg.TEST.POST_PROCESS
    soft = cfg.TEST.SOFT_ARGMAX  # the soft-argmax decode (:129-162)
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
        if soft:
            preds, maxvals = get_final_preds_softargmax(
                out, batch["center"], batch["scale"], post_process=post)
        else:
            coords, maxvals = decode_heatmaps(out, post_process=post)
            h, w = out.shape[2], out.shape[3]
            preds = transform_preds_batch(coords, batch["center"],
                                          batch["scale"], (w, h))
        metrics = {"loss": loss, "acc": acc, "acc_cnt": cnt,
                   "pck_hit_j": hit_j, "pck_valid_j": val_j}
        if debug:
            return preds, maxvals, metrics, debug_outputs(out)
        return preds, maxvals, metrics

    step.forward = forward
    return step


# ---------------------------------------------------------------------------
# Bottom-up (HigherHRNet) steps (advmix_tpu/engine/steps.py:433-772)
# ---------------------------------------------------------------------------

def _mask_at(mask, h: int, w: int):
    """The (B, S, S) input-resolution valid mask at an output scale,
    re-binarized: a bilinear resize (antialiased when it shrinks, as
    `jax.image.resize`) and a 0.5 threshold. None passes through."""
    if mask is None:
        return None
    if mask.shape[1] == h and mask.shape[2] == w:
        return mask
    m = resize_bilinear(mask[:, None], (h, w))[:, 0]
    return (m > 0.5).to(torch.float32)


def _bottomup_losses(cfg, pull_factor: float, push_factor: float):
    """(pose_loss, kd_loss) of the bottom-up steps. `masks` holds the
    valid mask at each output's scale (entries None for an unmasked
    loss)."""
    num_joints = cfg.MODEL.NUM_JOINTS
    input_size = int(cfg.MODEL.IMAGE_SIZE[0])
    sigma = float(cfg.MODEL.SIGMA)

    def pose_loss(outs, joints, vis, masks):
        """Per-scale heatmap MSE + the AE terms of the 1/4 head. Returns
        (total, pull, push)."""
        total = 0.0
        pull = push = None
        for si, (out, mask) in enumerate(zip(outs, masks)):
            h, w = out.shape[2], out.shape[3]
            with torch.no_grad():
                tgt, locs = generate_bottomup_target(
                    joints * (h / input_size), vis, (w, h), sigma)
            total = total + bottomup_heatmap_loss(out[:, :num_joints], tgt,
                                                  mask=mask)
            if si == 0:
                pull, push = ae_loss(out[:, num_joints:], locs, vis)
        return total + pull_factor * pull + push_factor * push, pull, push

    def kd_loss(outs, teacher_outs, masks):
        # the ignore regions carry no supervision for the KD term either
        total = 0.0
        for out, tout, mask in zip(outs, teacher_outs, masks):
            total = total + bottomup_heatmap_loss(
                out[:, :num_joints], tout[:, :num_joints].detach(),
                mask=mask)
        return total

    return pose_loss, kd_loss


def _masks_for(mask, outs) -> list:
    return [_mask_at(mask, o.shape[2], o.shape[3]) for o in outs]


def _no_pck(device) -> dict:
    """PCK has no single-person meaning bottom-up: a constant 0 count."""
    return {"acc": torch.zeros((), device=device),
            "acc_cnt": torch.zeros((), dtype=torch.int64, device=device)}


def make_bottomup_step(state, cfg, pull_factor: float = 0.001,
                       push_factor: float = 0.001):
    """Returns `step(batch) -> metrics` that trains `state.model` on
    batch["image"] (B, 3, S, S) against batch["joints"] (B, M, J, 2) in
    input coordinates, batch["joints_vis"] (B, M, J) and the optional
    batch["mask"] (B, S, S). Metrics are device tensors: loss, pull, push,
    acc, acc_cnt."""
    pose_loss, _ = _bottomup_losses(cfg, pull_factor, push_factor)
    model, opt = state.model, state.optimizer

    def step(batch):
        model.train()
        opt.zero_grad(set_to_none=True)
        outs = model(batch["image"])
        loss, pull, push = pose_loss(outs, batch["joints"],
                                     batch["joints_vis"],
                                     _masks_for(batch.get("mask"), outs))
        loss.backward()
        opt.step()
        state.step += 1
        return {"loss": loss.detach(), "pull": pull.detach(),
                "push": push.detach(), **_no_pck(loss.device)}

    return step


def make_bottomup_advmix_step(state, cfg, alpha: float = 0.1,
                              adv_loss_weight: float = 1.0,
                              num_views: int = 3, pull_factor: float = 0.001,
                              push_factor: float = 0.001):
    """AdvMix min-max for the bottom-up family (HigherHRNet-W32 512x512
    AdvMix), sequenced as `make_advmix_step`: G mixes the K views, D
    updates on the detached mix against the bottom-up loss and the masked
    KD term of the frozen teacher's heatmaps, then G updates adversarially
    through the saved mix with the updated D in train mode (D's BN
    statistics update twice). batch: views (B, 3K, S, S), joints, joints_vis
    and the optional mask as for `make_bottomup_step`. Metrics: loss_d,
    loss_g, acc, acc_cnt."""
    pose_loss, kd_loss = _bottomup_losses(cfg, pull_factor, push_factor)
    d, g, teacher = state.model_d, state.model_g, state.teacher
    opt_d, opt_g = state.optimizer_d, state.optimizer_g

    def step(batch):
        views = batch["views"]
        joints, vis = batch["joints"], batch["joints_vis"]
        d.train()
        g.train()
        mixed, w = mix_views(g(views), views, num_views)
        step.last_mix_weights = w.detach()
        with torch.no_grad():
            teacher_outs = teacher(views[:, :3])

        # ---- D update on the detached mix ----
        opt_d.zero_grad(set_to_none=True)
        outs = d(mixed.detach())
        masks = _masks_for(batch.get("mask"), outs)
        loss_d = (pose_loss(outs, joints, vis, masks)[0] * (1.0 - alpha)
                  + kd_loss(outs, teacher_outs, masks) * alpha)
        loss_d.backward()
        opt_d.step()
        del outs, teacher_outs

        # ---- G update through the saved mix ----
        mixed_in = mixed.detach().requires_grad_(True)
        loss_g = -pose_loss(d(mixed_in), joints, vis, masks)[0] \
            * adv_loss_weight
        (dmixed,) = torch.autograd.grad(loss_g, mixed_in)
        opt_g.zero_grad(set_to_none=True)
        mixed.backward(dmixed)
        opt_g.step()

        state.step += 1
        return {"loss_d": loss_d.detach(), "loss_g": loss_g.detach(),
                **_no_pck(loss_d.device)}

    step.last_mix_weights = None
    return step


def bottomup_infer_fn(model, cfg, flip_pairs, max_peaks: int = 30,
                      scales=(1.0,)):
    """Bottom-up inference of an eval-mode model: `infer(image) -> (heat,
    tags, peaks)` for NHWC normalized images (B, S, S, 3). The output
    scales are aggregated at the 1/2 resolution (`aggregate_heatmaps`);
    with TEST.FLIP_TEST the flipped pass's heatmaps are flipped back and
    averaged, and its tags flipped back and stacked as a second tag
    dimension (T=2, the published flip protocol). `scales` beyond (1.0,)
    is the published multi-scale test (e.g. [0.5, 1, 2]): scale 1 runs
    first and fixes the aggregation resolution; every other scale's input
    is resized on the device and its flip-averaged heatmaps brought to that
    resolution and averaged in; the tags come from scale 1 only.
    Returns heat (B, J, h, w), tags (B, J, h, w[, 2]) and the
    `top_k_peaks` dict, all f32 for a bf16 model."""
    flip_test = cfg.TEST.FLIP_TEST
    pairs = tuple(tuple(p) for p in flip_pairs)
    input_size = int(cfg.MODEL.IMAGE_SIZE[0])
    scales = tuple(float(s) for s in scales)
    assert 1.0 in scales, "the base test scale 1 is required"

    def one_scale(x, target_hw, with_tags: bool):
        outs = model(x)
        hw = target_hw or (outs[-1].shape[2], outs[-1].shape[3])
        heat, tags = aggregate_heatmaps(outs, hw)
        if flip_test:
            heat_f, tags_f = aggregate_heatmaps(model(x.flip(3)), hw)
            heat = (heat + flip_back(heat_f, pairs)) * 0.5
            if with_tags:
                tags = torch.stack([tags, flip_back(tags_f, pairs)], dim=-1)
        return heat, hw, (tags if with_tags else None)

    @torch.no_grad()
    def infer(image):
        x = image.permute(0, 3, 1, 2)  # NHWC -> NCHW
        heat, target_hw, tags = one_scale(x, None, True)
        if len(scales) > 1:
            heat_sum = heat
            for s in sorted(scales, reverse=True):
                if s == 1.0:
                    continue
                size = int(input_size * s)
                h_s, _, _ = one_scale(resize_bilinear(x, (size, size)),
                                      target_hw, False)
                heat_sum = heat_sum + h_s
            heat = heat_sum / float(len(scales))
        return heat, tags, top_k_peaks(heat, tags, k=max_peaks)

    return infer


def make_bottomup_eval_step(model, cfg, flip_pairs, max_peaks: int = 30,
                            scales=(1.0,)):
    """`step(batch) -> (heat, tags, peaks)` of `bottomup_infer_fn` on
    batch["image"]."""
    infer = bottomup_infer_fn(model, cfg, flip_pairs, max_peaks, scales)

    def step(batch):
        return infer(batch["image"])

    return step
