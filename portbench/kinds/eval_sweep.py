"""The on-the-fly robustness sweep, one rank: the per-batch body of the
program's `engine.trainer.validate` as `tools/test_corruption --on_the_fly`
drives it.

Each batch takes host crops from a pool (as the sweep's cached loader
replays them), moves them through the program's `trainer.to_device`, runs
`trainer.make_eval_preprocessor(corruption=c, severity=s)` (the exact-render
corruption, normalization, targets) and `steps.make_eval_step` (two
forwards for the flip test, the decode kernel, the inverse affine), and
copies the predictions and maxima to the host and reads the loss and PCK
as `validate` does. The passes (c, s) follow the traffic file's list, one
per batch, and repeat. Set-up builds every pass's preprocessor and runs it
once at the full batch, so the corruptions' cached constants and cuDNN's
plans are made before the window.

Output check: a sample of the window's batches, drawn from the seed, is
recomputed by the reference (corruption, both forwards, decode, transform);
the program's answers are judged by `reference.evaluate.judge`.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from .. import flops, inputs
from ..core import percentile
from ..reference import evaluate, models, numerics
from ..trace import span
from . import common


class CellRun:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.cfg
        self.tr = ctx.cell.traffic
        self.conf = ctx.cell.config
        self.model_cfg = self.conf["yaml"]["MODEL"]
        self.batch = int(self.tr["batch"])
        self.image_size = tuple(int(v) for v in self.cfg.MODEL.IMAGE_SIZE)
        self.passes = [(c, int(s)) for c, s in self.tr["passes"]]
        self.k = 0
        # per window batch: (pool index, pass index, preds, maxvals)
        self.answers = []

    def _make_pool(self):
        dev, seed, b = self.ctx.device, self.ctx.seed, self.batch
        n_pool = int(self.tr["pool_batches"])
        w, h = self.image_size
        crops = inputs.smooth_images(n_pool * b, h, w,
                                     inputs.device_gen(seed, 1, dev),
                                     dev).cpu().numpy()
        rng = np.random.RandomState(inputs.sub_seed(seed, 2) % 2 ** 32)
        joints, vis = inputs.joints_in_crop(n_pool * b,
                                            self.cfg.MODEL.NUM_JOINTS,
                                            self.image_size,
                                            float(self.tr["visible"]), rng)
        center, scale = inputs.eval_boxes(n_pool * b, self.image_size, rng)
        self.pool = []
        for i in range(n_pool):
            sl = slice(i * b, (i + 1) * b)
            self.pool.append({
                "image": crops[sl], "joints": joints[sl],
                "joints_vis": vis[sl], "center": center[sl],
                "scale": scale[sl],
                "valid": np.ones(b, np.float32)})

    def setup(self):
        from advmix_tpu_torch.engine import steps, trainer
        from advmix_tpu_torch.models.layers import set_compute_dtype

        ctx, cfg, dev = self.ctx, self.cfg, self.ctx.device
        self._make_pool()
        self.weights = common.seeded_weights(self.model_cfg, self.image_size,
                                             ctx.seed, dev, False)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        model = common.port_pose(cfg, self.weights["d"], dev).eval()
        model = set_compute_dtype(model, common.dtype_of(cfg))
        self.model = model
        self.flip_pairs = [tuple(p) for p in self.conf["flip_pairs"]]
        self.step = steps.make_eval_step(model, cfg, self.flip_pairs)
        self.preps = [trainer.make_eval_preprocessor(
            cfg, dev, corruption=c, severity=s) for c, s in self.passes]
        self.to_device = trainer.to_device
        # every pass once at the full batch, then the whole body once
        hb = self.pool[0]
        raw = {k: self.to_device(v, dev) for k, v in hb.items()}
        for prep in self.preps:
            prep(raw["image"], raw["joints"], raw["joints_vis"])
        self._body(0, 0, False)
        self.answers.clear()

    def _body(self, pool_i: int, pass_i: int, traced: bool):
        dev = self.ctx.device
        hb = self.pool[pool_i]
        with span("pb.to_device", traced):
            raw = {k: self.to_device(v, dev) for k, v in hb.items()}
        with span("pb.prep", traced):
            batch = self.preps[pass_i](raw["image"], raw["joints"],
                                       raw["joints_vis"])
            batch.update(center=raw["center"], scale=raw["scale"],
                         valid=raw["valid"])
        with span("pb.step", traced):
            preds, maxvals, metrics = self.step(batch)[:3]
        with span("pb.sync", traced):
            preds = preds.cpu().numpy()
            maxvals = maxvals.cpu().numpy()
            float(metrics["loss"])
            float(metrics["acc"])
            int(metrics["acc_cnt"])
        self.answers.append((pool_i, pass_i, preds, maxvals))

    def iteration(self, i: int, traced: bool) -> None:
        k = self.k
        self.k += 1
        self._body(k % len(self.pool), k % len(self.passes), traced)

    def end_to_end(self, times, window) -> dict:
        return {"eval_img_s": len(times) * self.batch / window,
                "eval_batch_ms_p95": percentile(times, 95) * 1e3}

    def flops_per_iter(self) -> float:
        return flops.eval_batch_flops(self.model_cfg, self.batch,
                                      self.image_size)

    def trace_extra(self) -> dict:
        hw = tuple(int(v) for v in self.cfg.MODEL.HEATMAP_SIZE)
        return {"decode_bytes": flops.decode_bytes(
            self.batch, self.cfg.MODEL.NUM_JOINTS, hw[1], hw[0])}

    def release(self) -> None:
        for k in ("model", "step", "preps"):
            self.__dict__.pop(k, None)
        gc.collect()

    # -- output check --------------------------------------------------
    def check_batches(self) -> list:
        return common.sample(len(self.answers),
                             min(int(self.tr["check_batches"]),
                                 len(self.answers)), self.ctx.seed)

    def reference_heatmaps(self, pool_i, pass_i, model):
        dev = self.ctx.device
        hb = self.pool[pool_i]
        c, s = self.passes[pass_i]
        img = evaluate.corrupted(torch.from_numpy(hb["image"]).to(dev), c, s)
        return evaluate.heatmaps(model, img, self.flip_pairs)

    def reference_model(self, quant=None):
        d = common.reference_pose(self.model_cfg, self.ctx.device)
        d.load_state_dict(self.weights["d"])
        return models.set_quant(d.eval(), quant)

    def judge(self, answers, model) -> dict:
        """The numbers of the output check over every map of `answers`
        (the limits file says which are compared): the largest, the 99th
        percentile and the mean of the heat gaps, the largest maximum
        gap."""
        heat, mv = [], []
        dev = self.ctx.device
        for pool_i, pass_i, preds, maxvals in answers:
            hb = self.pool[pool_i]
            hm = self.reference_heatmaps(pool_i, pass_i, model)
            h, m = evaluate.judge(
                hm, torch.from_numpy(preds).to(dev),
                torch.from_numpy(maxvals).to(dev),
                torch.from_numpy(hb["center"]).to(dev),
                torch.from_numpy(hb["scale"]).to(dev))
            heat.append(h.flatten())
            mv.append(m.flatten())
        heat, mv = torch.cat(heat), torch.cat(mv)
        return {"heat_gap": float(heat.max()),
                "heat_gap_p99": float(torch.quantile(heat, 0.99)),
                "heat_gap_mean": float(heat.mean()),
                "maxval_gap": float(mv.max())}

    def check(self) -> dict:
        with numerics.exact_f32():
            model = self.reference_model()
            out = self.judge([self.answers[i] for i in self.check_batches()],
                             model)
        del model
        gc.collect()
        return out
