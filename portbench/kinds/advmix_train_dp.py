"""AdvMix min-max training over data-parallel ranks, one card a rank: the
per-iteration body of the program's `engine.trainer.train_epoch` on each
rank of a `torch.distributed` group, with the step's own collectives
(`engine/steps.make_advmix_step(group=...)`: D's and G's gradients averaged
before their optimizer steps, D's BatchNorm statistics averaged after each,
the losses averaged; per-rank BatchNorm batch statistics, since the
configuration's TRAIN.CROSS_REPLICA_BN is off). Several ranks run the
eager step: no collective runs inside a CUDA graph.

The traffic file's `ranks` ranks each take `batch` images of every global
batch of `batch x ranks` (rank r rows [r b, (r + 1) b)), from the same
seeded pool as the `advmix_train` kind builds, and synthesize their views
with a generator of their own. Rank 0 runs in the benchmark's process on
`cuda:0`, so that its profiler sees it; ranks 1.. are spawned processes on
`cuda:1`.. (the CPU, with gloo, where the context's device is the CPU).
They join through the program's `parallel/dist.init_process_group`, and
the weights are broadcast from rank 0 (`broadcast_module_`). Before every
iteration rank 0 sends the others, over a gloo group of the benchmark's
own, whether to run it, so every rank runs as many iterations as rank 0
and stops when its window ends; a watchdog ends rank 0 if another rank
dies, so that no collective waits forever.

`train_img_s` counts the images of all ranks; the other numbers are rank
0's. The output check compares rank 0's readings after the first
`first_steps` iterations (the averaged losses, the averaged first
gradients read back from Adam, the change of the parameters and of the
averaged BatchNorm statistics, its shard's first mixing weights) with
`reference/train_dp.AdvMixDPReference`, which runs the same shards one after
another on rank 0's device. Faults planted by `calibrate` reach rank 0's
step only.
"""

from __future__ import annotations

import gc
import os
import shutil
import sys
import tempfile
import threading
import time

import torch

from .. import core, inputs
from ..reference import augment, models, numerics, train, train_dp
from ..reference import warp as ref_warp
from . import advmix_train, common

JOIN_S = 120.0  # how long rank 0 waits for the others to exit


def _view_seed(seed: int, rank: int) -> int:
    """The views' generator of rank `rank`: rank 0 the `advmix_train`
    kind's own stream, the others streams of their own."""
    return inputs.sub_seed(seed, 3 if rank == 0 else 40 + rank)


def _devices(device, ranks: int) -> list:
    if device.type == "cuda":
        return [f"cuda:{r}" for r in range(ranks)]
    return ["cpu"] * ranks


def _rank_main(cell, seed: int, rank: int, device: str, init_file: str,
               float64: bool) -> None:
    """A spawned rank: set up, then run an iteration whenever rank 0 says
    so, and leave when it says stop."""
    sys.stdout = sys.stderr  # rank 0's standard output is the result line
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)
    cfg = core.port_config(cell.config)
    torch.backends.cudnn.benchmark = bool(cfg.CUDNN.BENCHMARK)
    ctx = core.Context(cell=cell, cfg=cfg, seed=seed, device=device,
                       float64=float64)
    work = CellRun(ctx, rank=rank, init_file=init_file)
    work.setup()
    i = work.k
    while work.go():
        advmix_train.CellRun.iteration(work, i, False)
        i += 1
    work.release()


class CellRun(advmix_train.CellRun):
    def __init__(self, ctx, rank: int = 0, init_file: str | None = None):
        super().__init__(ctx)
        self.ranks = int(self.tr["ranks"])
        self.rank = rank
        self.init_file = init_file
        self.procs, self.tmp, self.flags = [], None, None
        self.stopped = threading.Event()

    # -- inputs --------------------------------------------------------
    def _make_pool(self):
        """The pool of global batches; `pool` holds this rank's shards."""
        b = self.batch
        self.batch = b * self.ranks
        try:
            super()._make_pool()
        finally:
            self.batch = b
        self.global_pool = self.pool
        r = slice(self.rank * b, (self.rank + 1) * b)
        self.pool = [{k: v[r] for k, v in hb.items()}
                     for hb in self.global_pool]

    # -- the ranks -----------------------------------------------------
    def _spawn(self) -> None:
        import torch.multiprocessing as mp

        self.tmp = tempfile.mkdtemp(prefix="portbench_ranks_")
        self.init_file = os.path.join(self.tmp, "init")
        ctx = mp.get_context("spawn")
        devices = _devices(self.ctx.device, self.ranks)
        for r in range(1, self.ranks):
            # daemonic: they end with this process, whatever stops it
            p = ctx.Process(target=_rank_main, args=(
                self.ctx.cell, self.ctx.seed, r, devices[r], self.init_file,
                self.ctx.float64), daemon=True)
            p.start()
            self.procs.append(p)
        threading.Thread(target=self._watch, daemon=True).start()

    def _watch(self) -> None:
        """End rank 0 if another rank exits with an error before it is
        told to stop: its collectives would wait for that rank forever."""
        while not self.stopped.is_set():
            for r, p in enumerate(self.procs, start=1):
                if p.exitcode not in (None, 0) and not self.stopped.is_set():
                    print(f"[portbench] rank {r} failed (exit code "
                          f"{p.exitcode}): stopping", file=sys.stderr,
                          flush=True)
                    for q in self.procs:
                        q.terminate()
                    os._exit(5)
            time.sleep(0.5)

    def go(self, run: bool = True) -> bool:
        """Rank 0 tells the others whether the next iteration runs (`run`);
        the others return what it said."""
        t = torch.tensor([int(run)])
        torch.distributed.broadcast(t, 0, group=self.flags)
        return bool(t.item())

    # -- set-up --------------------------------------------------------
    def setup(self):
        from advmix_tpu_torch.engine import state as state_lib, steps, \
            trainer
        from advmix_tpu_torch.parallel import dist

        ctx, cfg, dev = self.ctx, self.cfg, self.ctx.device
        if self.rank == 0:
            self._spawn()
        dist.init_process_group(self.rank, self.ranks,
                                _devices(dev, self.ranks), self.init_file)
        self.flags = torch.distributed.new_group(backend="gloo")
        group = dist.data_group()
        self._make_pool()
        self.weights = common.seeded_weights(self.model_cfg, self.image_size,
                                             ctx.seed, dev, True)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        d = common.port_pose(cfg, self.weights["d"], dev)
        g = common.port_generator(self.weights["g"], dev)
        dist.broadcast_module_(d)
        dist.broadcast_module_(g)
        dtype = common.dtype_of(cfg)
        if ctx.float64:
            d, g, dtype = d.double(), g.double(), torch.float64
        self.state = state_lib.create_advmix_state(cfg, d, g, dev, dtype)
        self.step = steps.make_advmix_step(
            self.state, cfg, alpha=advmix_train.ALPHA,
            adv_loss_weight=advmix_train.ADV_WEIGHT, group=group)
        self.prep = trainer.make_preprocessor(
            cfg, advmix=True, device=dev,
            device_warp=bool(cfg.DATASET.DEVICE_WARP))
        self.to_device = trainer.to_device
        self.gen = torch.Generator().manual_seed(_view_seed(ctx.seed,
                                                            self.rank))

        d, g = self.state.model_d, self.state.model_g
        p0 = {("d", k): v.detach().clone() for k, v in d.named_parameters()}
        p0.update({("g", k): v.detach().clone()
                   for k, v in g.named_parameters()})
        b0 = {k: v.detach().clone()
              for k, v in advmix_train._bn_buffers(d).items()}
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
            "d": advmix_train._host({k: v - p0[("d", k)]
                                     for k, v in d.named_parameters()}),
            "g": advmix_train._host({k: v - p0[("g", k)]
                                     for k, v in g.named_parameters()}),
            "bn": advmix_train._host({
                k: v - b0[k]
                for k, v in advmix_train._bn_buffers(d).items()})}
        del p0, b0
        for i in range(int(self.tr["warm_steps"])):
            self.iteration(first + i, False)

    # -- the timed unit ------------------------------------------------
    def iteration(self, i: int, traced: bool) -> None:
        self.go(True)
        super().iteration(i, traced)

    def end_to_end(self, times, window) -> dict:
        out = super().end_to_end(times, window)
        out["train_img_s"] *= self.ranks
        return out

    def release(self) -> None:
        from advmix_tpu_torch.parallel import dist

        if self.flags is not None:
            if self.rank == 0:
                self.go(False)
            # every rank has its stop before any tears its groups down; then
            # all together, since NCCL's teardown waits for the node's other
            # ranks: rank 0 must not wait for them to exit first
            torch.distributed.barrier(group=self.flags)
        dist.destroy_process_group()
        self.flags = None
        if self.rank == 0 and self.procs:
            for p in self.procs:
                p.join(JOIN_S)
            self.stopped.set()  # the watchdog ends
            for p in self.procs:
                if p.is_alive():
                    p.terminate()
                    p.join()
            bad = [p.exitcode for p in self.procs if p.exitcode != 0]
            if bad:
                raise RuntimeError(f"ranks exited with codes {bad}")
        if self.tmp is not None:
            shutil.rmtree(self.tmp, ignore_errors=True)
        super().release()

    # -- output check --------------------------------------------------
    def reference(self, quant=None, perturb: float = 0.0) -> dict:
        """`advmix_train.CellRun.reference` over the ranks' shards
        (`train_dp.AdvMixDPReference`), each shard's views from its rank's
        generator."""
        cfg, dev = self.cfg, self.ctx.device
        w, h = self.image_size
        dtype = torch.float64 if self.ctx.float64 else torch.float32
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
            ref = train_dp.AdvMixDPReference(
                d, g, float(cfg.TRAIN.LR), self.ranks, advmix_train.ALPHA,
                advmix_train.ADV_WEIGHT, str(cfg.TRAIN.OPTIMIZER),
                float(cfg.TRAIN.WD))
            b0 = {k: v.detach().clone()
                  for k, v in advmix_train._bn_buffers(d).items()}
            gens = [torch.Generator().manual_seed(_view_seed(self.ctx.seed,
                                                             r))
                    for r in range(self.ranks)]
            losses = []
            for i in range(int(self.tr["first_steps"])):
                hb = self.global_pool[i]
                img = torch.from_numpy(hb["image"]).to(dev)
                mats = torch.from_numpy(hb["warp_matrix"]).to(dev)
                clean = ref_warp.warp_affine(img, mats, (w, h)).permute(
                    0, 3, 1, 2)
                views = torch.cat([augment.make_advmix_views(
                    c, gen, out_dtype=view_dtype, compute_dtype=view_dtype)
                    for c, gen in zip(clean.chunk(self.ranks), gens)])
                views = views.to(dtype)
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
                "bn": {k: v - b0[k]
                       for k, v in advmix_train._bn_buffers(d).items()}}
            out = {"losses": losses, "first_grads": ref.first_grads,
                   "change": change, "first_mix": ref.first_mix_weights}
        del ref, d, g
        gc.collect()
        return out
