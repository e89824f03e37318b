"""AdvMix min-max training, one rank: the per-iteration body of the
program's `engine.trainer.train_epoch`.

Each iteration hands the program what its train loader hands it under the
configuration's DATASET.DEVICE_WARP (source images padded into the warp
bucket, crop matrices, joints and visibilities), through the program's own
`trainer.to_device`; then `trainer.make_preprocessor(advmix=True)` (warp,
3-view synthesis, targets), `steps.make_advmix_step` (G and the mix, the
teacher, D's update, G's update) and the loop's read-back of the metrics as
floats, which waits for the device. The traffic file gives the batch, the
pool of distinct batches that the window cycles through, the source size
and the visibility rate; the augmentation's ranges are the configuration's.

Output check: the first `first_steps` iterations run in set-up through the
same calls on distinct batches; the program's losses (D's and G's), its
first gradients (read back from Adam's first moment after step 1, D's and
G's) and the change of D's and G's parameters and of D's BatchNorm
statistics after those steps are compared with the reference's, leaf by
leaf, by norm and element by element.
"""

from __future__ import annotations

import gc
import math

import numpy as np
import torch

from .. import flops, inputs
from ..core import percentile
from ..reference import augment, models, numerics, train
from ..reference import warp as ref_warp
from ..trace import span
from . import common

ALPHA = 0.1  # tools/train --alpha default
ADV_WEIGHT = 1.0  # tools/train --adv_loss_weight default


def _host(named: dict) -> dict:
    """Copies on the host, so that the device's peak stays the program's."""
    return {k: v.detach().cpu() for k, v in named.items()}


def _bn_buffers(model) -> dict:
    return {k: v for k, v in model.named_buffers()
            if k.endswith(("running_mean", "running_var"))}


class CellRun:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.cfg
        self.tr = ctx.cell.traffic
        self.model_cfg = ctx.cell.config["yaml"]["MODEL"]
        self.batch = int(self.tr["batch"])
        self.image_size = tuple(int(v) for v in self.cfg.MODEL.IMAGE_SIZE)
        self.k = 0

    # -- inputs --------------------------------------------------------
    def _make_pool(self):
        cfg, tr, dev, seed = self.cfg, self.tr, self.ctx.device, self.ctx.seed
        n_pool = int(tr["pool_batches"])
        b = self.batch
        sh, sw = tr["source_hw"]
        bh, bw = (int(v) for v in cfg.DATASET.WARP_BUCKET)
        imgs = inputs.smooth_images(n_pool * b, sh, sw,
                                    inputs.device_gen(seed, 1, dev), dev)
        padded = torch.zeros((n_pool * b, bh, bw, 3), dtype=torch.uint8,
                             device=dev)
        padded[:, :sh, :sw] = imgs
        host = padded.cpu().numpy()
        del imgs, padded
        rng = np.random.RandomState(inputs.sub_seed(seed, 2) % 2 ** 32)
        mats = inputs.train_boxes(n_pool * b, (sh, sw), self.image_size,
                                  dict(cfg.DATASET), rng)
        joints, vis = inputs.joints_in_crop(n_pool * b, cfg.MODEL.NUM_JOINTS,
                                            self.image_size,
                                            float(tr["visible"]), rng)
        self.pool = [{"image": host[i * b:(i + 1) * b],
                      "warp_matrix": mats[i * b:(i + 1) * b],
                      "joints": joints[i * b:(i + 1) * b],
                      "joints_vis": vis[i * b:(i + 1) * b]}
                     for i in range(n_pool)]
        if not bool(cfg.DATASET.DEVICE_WARP):
            raise ValueError("advmix_train feeds the DEVICE_WARP path")

    # -- set-up --------------------------------------------------------
    def setup(self):
        from advmix_tpu_torch.engine import state as state_lib, steps, \
            trainer

        ctx, cfg, dev = self.ctx, self.cfg, self.ctx.device
        self._make_pool()
        self.weights = common.seeded_weights(self.model_cfg, self.image_size,
                                             ctx.seed, dev, True)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        d = common.port_pose(cfg, self.weights["d"], dev)
        g = common.port_generator(self.weights["g"], dev)
        dtype = common.dtype_of(cfg)
        if ctx.float64:
            d, g, dtype = d.double(), g.double(), torch.float64
        self.state = state_lib.create_advmix_state(cfg, d, g, dev, dtype)
        self.step = steps.make_advmix_step(self.state, cfg, alpha=ALPHA,
                                           adv_loss_weight=ADV_WEIGHT)
        self.prep = trainer.make_preprocessor(
            cfg, advmix=True, device=dev,
            device_warp=bool(cfg.DATASET.DEVICE_WARP))
        self.to_device = trainer.to_device
        self.gen = torch.Generator().manual_seed(
            inputs.sub_seed(ctx.seed, 3))

        # the first steps, through the window's own call, read for the check
        d, g = self.state.model_d, self.state.model_g
        p0 = {("d", k): v.detach().clone() for k, v in d.named_parameters()}
        p0.update({("g", k): v.detach().clone()
                   for k, v in g.named_parameters()})
        b0 = {k: v.detach().clone() for k, v in _bn_buffers(d).items()}
        self.losses = []
        first = int(self.tr["first_steps"])
        for i in range(first):
            self.iteration(i, False)
            self.losses.append(dict(self.last))
            if i == 0:
                self.first_grads = {"d": self._first_grad(
                    d, self.state.optimizer_d), "g": self._first_grad(
                    g, self.state.optimizer_g)}
                self.first_mix = self.step.last_mix_weights.cpu()
        self.change = {
            "d": _host({k: v - p0[("d", k)]
                        for k, v in d.named_parameters()}),
            "g": _host({k: v - p0[("g", k)]
                        for k, v in g.named_parameters()}),
            "bn": _host({k: v - b0[k] for k, v in _bn_buffers(d).items()})}
        del p0, b0
        for i in range(int(self.tr["warm_steps"])):
            self.iteration(first + i, False)

    @staticmethod
    def _first_grad(model, opt) -> dict:
        """The gradient Adam got at its first step: exp_avg / (1 - beta1),
        on the host."""
        beta1 = opt.param_groups[0]["betas"][0]
        out = {}
        for k, p in model.named_parameters():
            m = opt.state.get(p, {}).get("exp_avg")
            out[k] = (torch.zeros(p.shape, dtype=p.dtype) if m is None
                      else (m.detach() / (1.0 - beta1)).cpu())
        return out

    # -- the timed unit ------------------------------------------------
    def iteration(self, i: int, traced: bool) -> None:
        hb = self.pool[self.k % len(self.pool)]
        self.k += 1
        dev = self.ctx.device
        with span("pb.to_device", traced):
            raw = {k: self.to_device(v, dev) for k, v in hb.items()}
        with span("pb.prep", traced):
            batch = self.prep(raw, self.gen)
        with span("pb.step", traced):
            result = self.step(batch)
        with span("pb.sync", traced):
            self.last = {k: float(v) for k, v in result.items()}

    def end_to_end(self, times, window) -> dict:
        return {"train_img_s": len(times) * self.batch / window,
                "train_iter_ms_p85": percentile(times, 85) * 1e3}

    def flops_per_iter(self) -> float:
        return flops.advmix_iteration_flops(self.model_cfg, self.batch,
                                            self.image_size)

    def trace_extra(self) -> dict:
        return {}

    def release(self) -> None:
        for k in ("state", "step", "prep", "last"):
            self.__dict__.pop(k, None)
        gc.collect()

    # -- output check --------------------------------------------------
    def reference(self, quant=None, perturb: float = 0.0) -> dict:
        """The reference's losses, first gradients and changes over the
        first steps, from the same weights and inputs; `quant` routes its
        convolutions through a lower precision (the control); `perturb`
        scales each view element by 1 + perturb x N(0, 1), seeded (the
        numbers' own sensitivity, read by `calibrate --perturb`)."""
        cfg, dev = self.cfg, self.ctx.device
        w, h = self.image_size
        dtype = torch.float64 if self.ctx.float64 else torch.float32
        # the views are synthesized in the configuration's training dtype
        # (bfloat16 rounds the warped image to whole levels above 128, as
        # the original's uint8 warp does, before AutoAugment's thresholds)
        view_dtype = torch.bfloat16 if str(cfg.TRAIN.DTYPE) == "bfloat16" \
            else torch.float32
        with numerics.exact_f32():
            d = common.reference_pose(self.model_cfg, dev)
            d.load_state_dict(self.weights["d"])
            with torch.device(dev):
                g = models.Unet()
            g.load_state_dict(self.weights["g"])
            d, g = d.to(dtype), g.to(dtype)
            models.set_quant(d, quant)
            models.set_quant(g, quant)
            ref = train.AdvMixReference(d, g, float(cfg.TRAIN.LR), ALPHA,
                                        ADV_WEIGHT, str(cfg.TRAIN.OPTIMIZER),
                                        float(cfg.TRAIN.WD))
            b0 = {k: v.detach().clone() for k, v in _bn_buffers(d).items()}
            gen = torch.Generator().manual_seed(
                inputs.sub_seed(self.ctx.seed, 3))
            losses = []
            for i in range(int(self.tr["first_steps"])):
                hb = self.pool[i]
                img = torch.from_numpy(hb["image"]).to(dev)
                mats = torch.from_numpy(hb["warp_matrix"]).to(dev)
                clean = ref_warp.warp_affine(img, mats, (w, h))
                views = augment.make_advmix_views(
                    clean.permute(0, 3, 1, 2), gen, out_dtype=view_dtype,
                    compute_dtype=view_dtype).to(dtype)
                if perturb:
                    noise = torch.randn(views.shape, generator=torch.Generator(
                        ).manual_seed(i), dtype=torch.float64).to(dev)
                    views = views * (1.0 + perturb * noise).to(dtype)
                target, tw = train.targets(
                    torch.from_numpy(hb["joints"]).to(dev),
                    torch.from_numpy(hb["joints_vis"]).to(dev),
                    self.image_size, tuple(cfg.MODEL.HEATMAP_SIZE),
                    float(cfg.MODEL.SIGMA))
                losses.append(ref.step(views, target, tw))
            change = {
                "d": {k: (v - self.weights["d"][k].to(dev)).detach()
                      for k, v in d.named_parameters()},
                "g": {k: (v - self.weights["g"][k].to(dev)).detach()
                      for k, v in g.named_parameters()},
                "bn": {k: v - b0[k] for k, v in _bn_buffers(d).items()}}
            out = {"losses": losses, "first_grads": ref.first_grads,
                   "change": change, "first_mix": ref.first_mix_weights}
        del ref, d, g
        gc.collect()
        return out

    def compare(self, prog: dict, ref: dict, why: dict | None = None
                ) -> dict:
        """The numbers of the output check; the limits file says which are
        compared, PERF.md gives the readings of all. Loss gaps (relative):
        the worst of the first steps, D's and G's, and D's first step
        alone; the first step's mixing weights element by element
        (`train.mix_diff`). Leaf by leaf (`train.leaf_numbers`), the median leaf's gap
        of norms and difference element by element of: the first gradient
        (D, G), the change over the first steps (D, G: the leaves that the
        reference moves; D's BatchNorm statistics); and the worst leaf's
        gap of norms over the gradients and over the changes. `why`, if
        given, gets the worst leaves with their norms."""
        def loss_gap(key, steps):
            return max(abs(p[key] - r[key]) / max(abs(r[key]), 1e-12)
                       for p, r in list(zip(prog["losses"],
                                            ref["losses"]))[:steps])

        groups = {f"grad_{m}": train.leaf_numbers(prog["first_grads"][m],
                                                  ref["first_grads"][m])
                  for m in "dg"}
        for m in "dg":
            groups[f"change_{m}"] = train.leaf_numbers(
                prog["change"][m], ref["change"][m],
                train.moving_leaves(ref["first_grads"][m]))
        groups["change_bn"] = train.leaf_numbers(prog["change"]["bn"],
                                                 ref["change"]["bn"])
        out = {"loss_d_gap": loss_gap("loss_d", len(prog["losses"])),
               "loss_g_gap": loss_gap("loss_g", len(prog["losses"])),
               "loss_d1_gap": loss_gap("loss_d", 1),
               "mix1_diff": train.mix_diff(prog["first_mix"],
                                           ref["first_mix"])}
        for name, n in groups.items():
            out[f"{name}_median_gap"] = train.median(list(n["gap"].values()))
            out[f"{name}_median_diff"] = train.median(
                list(n["diff"].values()))

        def worst(kind):
            best = (math.nan, None, None)
            for name, n in groups.items():
                if not name.startswith(kind):
                    continue
                for k, v in n["gap"].items():
                    if not v <= best[0]:
                        best = (v, f"{name}:{k}", n)
            return best

        for kind in ("grad", "change"):
            v, leaf, n = worst(kind)
            out[f"{kind}_gap"] = v
            if why is not None and leaf is not None:
                k = leaf.split(":", 1)[1]
                why[f"{kind}_gap"] = {
                    "leaf": leaf, "prog_norm": n["prog"][k],
                    "ref_norm": n["ref"][k], "median_ref_norm":
                    n["den_median"], "diff": n["diff"][k]}
        return out

    def program_readings(self) -> dict:
        return {"losses": self.losses, "first_grads": self.first_grads,
                "change": self.change, "first_mix": self.first_mix}

    def check(self) -> dict:
        return self.compare(self.program_readings(), self.reference())
