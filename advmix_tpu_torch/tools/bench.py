"""Bench of the AdvMix min-max step on the CUDA device.

    python -m advmix_tpu_torch.tools.bench [--cfg <yaml>] [--batch 128] \
        [--dtype bfloat16] [--iters 10] [--int8_teacher]

Counterpart of `bench.py` for the port: the 3-view synthesis from uint8
crops plus the AdvMix step (`bench.py:319-330` fuses the same two), at full
width of the config (default HRNet-W32 256x192), the models' seeded initial
weights,
timed with CUDA events after warm-up. Prints one JSON line with the time of
the view synthesis alone, of the step alone and of both, the images per
second of both, and the peak device memory. It raises without a card: a CPU
time is not a measurement of the port. A bottom-up YAML (pose_higher_hrnet,
`bench.py:255-275`) benches the bottom-up AdvMix step on whole 512x512
images of 10 people each, joints uniform over the image, all visible.
`--int8_teacher` gives the top-down step the W8A8 teacher of
TRAIN.INT8_TEACHER (`bench.py:289-305`), calibrated on the clean views of
the first 32 crops of the bench batch.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess

import torch

from ..config import get_default_config
from ..engine.state import create_advmix_state
from ..engine.steps import make_advmix_step, make_bottomup_advmix_step
from ..engine.trainer import make_bottomup_preprocessor, make_preprocessor
from ..models import get_generator, get_pose_net
from ..ops import quant
from ..utils.device import resolve_device

DEFAULT_CFG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "experiments/coco/hrnet/w32_256x192_advmix.yaml")


def events_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean ms of fn() by CUDA events around `iters` back-to-back calls
    after `warmup` calls, the host's launch overhead included (what a
    training loop waits)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def make_advmix_workload(cfg, device: torch.device, batch_size: int,
                         dtype: torch.dtype, seed: int = 0,
                         int8_teacher: bool = False):
    """The models, the step, the preprocessor and one raw batch of seeded
    uint8 crops on `device`. Returns (state, step, prep, raw, generator).
    With `int8_teacher` (top-down only) the teacher is the W8A8 copy of D,
    calibrated on the clean views of one prepared batch's first 32 crops
    (a generator of its own, so the timed draws are unchanged)."""
    gen = torch.Generator().manual_seed(seed)
    model = get_pose_net(cfg)
    state = create_advmix_state(cfg, model, get_generator(), device, dtype)
    w, h = cfg.MODEL.IMAGE_SIZE
    j = cfg.MODEL.NUM_JOINTS
    image = torch.randint(0, 256, (batch_size, h, w, 3), dtype=torch.uint8,
                          generator=gen).to(device)
    if cfg.MODEL.NAME == "pose_higher_hrnet":
        step = make_bottomup_advmix_step(state, cfg, alpha=0.1,
                                         adv_loss_weight=1.0)
        prep = make_bottomup_preprocessor(cfg, advmix=True, device=device)
        people = 10
        raw = {"image": image,
               "joints": (torch.rand(batch_size, people, j, 2, generator=gen)
                          * (min(w, h) - 2.0)).to(device),
               "joints_vis": torch.ones(batch_size, people, j,
                                        device=device)}
        return state, step, prep, raw, gen
    prep = make_preprocessor(cfg, advmix=True, device=device)
    raw = {
        "image": image,
        "joints": (torch.rand(batch_size, j, 2, generator=gen)
                   * torch.tensor([w - 1.0, h - 1.0])).to(device),
        "joints_vis": (torch.rand(batch_size, j, generator=gen)
                       > 0.2).float().to(device),
    }
    if int8_teacher:
        views = prep({k: v[:32] for k, v in raw.items()},
                     torch.Generator().manual_seed(7))["views"]
        state.teacher, _ = quant.int8_teacher_from_config(
            dtype, state.model_d, device=device,
            calib_images=[views[:, :3].to(torch.float32)])
    step = make_advmix_step(state, cfg, alpha=0.1, adv_loss_weight=1.0)
    return state, step, prep, raw, gen


def time_advmix(cfg, device: torch.device, batch_size: int,
                dtype: torch.dtype, iters: int = 10, warmup: int = 3,
                seed: int = 0, inspect=None, int8_teacher: bool = False
                ) -> dict:
    """Times the view synthesis alone, the AdvMix step alone (on one
    prepared batch) and both together at `batch_size`. Raises
    torch.cuda.OutOfMemoryError where the batch does not fit.
    `inspect(both)`, if given, is called after the timing with the
    callable that runs one synthesis and step (a profiler's hook); what it
    returns comes back under "inspect"."""
    if device.type != "cuda":
        raise RuntimeError("time_advmix measures the CUDA device only")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, step, prep, raw, gen = make_advmix_workload(
        cfg, device, batch_size, dtype, seed, int8_teacher)
    batch = prep(raw, gen)
    views_ms = events_ms(lambda: prep(raw, gen), iters, warmup)
    step_ms = events_ms(lambda: step(batch), iters, warmup)
    last = {}

    def both():
        last.update(step(prep(raw, gen)))

    both_ms = events_ms(both, iters, warmup)
    metrics = {k: float(v) for k, v in last.items()}
    peak = torch.cuda.max_memory_allocated()
    return dict(
        inspect=None if inspect is None else inspect(both),
        batch=batch_size, dtype=str(dtype).replace("torch.", ""),
        views_ms=views_ms, step_ms=step_ms, both_ms=both_ms,
        img_per_s=batch_size / both_ms * 1e3,
        peak_gib=peak / 2 ** 30,
        loss_d=metrics["loss_d"], loss_g=metrics["loss_g"],
        steps=state.step, int8_teacher=bool(int8_teacher))


def time_advmix_largest_fit(cfg, device, batch_size: int, dtype, **kw) -> dict:
    """`time_advmix` at `batch_size`, or at the largest smaller power of two
    that fits in the device's memory; `asked` keeps the size asked for."""
    b = batch_size
    while True:
        try:
            out = time_advmix(cfg, device, b, dtype, **kw)
            out["asked"] = batch_size
            return out
        except torch.cuda.OutOfMemoryError:
            if b <= 1:
                raise
            b = 1 << ((b - 1).bit_length() - 1)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cfg", default=DEFAULT_CFG)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--dtype", default="bfloat16",
                   choices=("bfloat16", "float32"))
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--int8_teacher", action="store_true",
                   help="the W8A8 teacher of TRAIN.INT8_TEACHER (top-down)")
    args = p.parse_args(argv)
    device = resolve_device(None)
    cfg = get_default_config()
    cfg.merge_from_file(args.cfg)
    cfg.TRAIN.DTYPE = args.dtype
    cfg.freeze()
    torch.backends.cudnn.benchmark = bool(cfg.CUDNN.BENCHMARK)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    if args.int8_teacher and cfg.MODEL.NAME == "pose_higher_hrnet":
        raise SystemExit("--int8_teacher: top-down only; a bottom-up config "
                         "ignores TRAIN.INT8_TEACHER")
    out = time_advmix_largest_fit(cfg, device, args.batch, dtype,
                                  iters=args.iters, seed=args.seed,
                                  int8_teacher=args.int8_teacher)
    out.update(metric="advmix_train_img_per_s", model=cfg.MODEL.NAME,
               image_size=list(cfg.MODEL.IMAGE_SIZE),
               device=torch.cuda.get_device_name(0), card=card_line())
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
