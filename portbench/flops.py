"""Operations and bytes of the work a cell does, and the chip's peaks.

Model FLOPs are counted by `torch.utils.flop_counter.FlopCounterMode` on the
reference models (`reference/models.py`) at the cell's shapes, on the meta
device, so nothing is computed and nothing of the program is asked: two per
multiply-add of every convolution and matrix product that the iteration
needs, none for norms, activations or the optimizer.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from .reference import models, train

# NVIDIA H100 SXM5 data sheet, dense rates (no sparsity), 700 W
PEAKS = {
    "bf16_flops": 989e12,
    "hbm_bytes_per_s": 3.35e12,
}


def _count(fn) -> float:
    with FlopCounterMode(display=False) as fc:
        fn()
    return float(fc.get_total_flops())


def advmix_iteration_flops(model_cfg: dict, batch: int, image_size) -> float:
    """One AdvMix iteration: G forward and backward (weights only; the
    views need no gradient), the teacher's forward, D forward and backward
    on the mix, and D forward plus the gradient to its input for G."""
    w, h = image_size
    with torch.device("meta"):
        d = models.pose_net(model_cfg)
        g = models.Unet()
        views = torch.empty((batch, 9, h, w))

    def run():
        g.train()
        d.train()
        mixed = train.mix(g(views), views)
        with torch.no_grad():
            d(views[:, :3])
        d(mixed.detach()).sum().backward()
        m_in = mixed.detach().requires_grad_(True)
        # only the input's gradient, as the G step asks of D
        torch.autograd.backward(d(m_in).sum(), inputs=[m_in])
        mixed.backward(m_in.grad)

    return _count(run)


def eval_batch_flops(model_cfg: dict, batch: int, image_size) -> float:
    """One flip-test eval batch: two forwards."""
    w, h = image_size
    with torch.device("meta"):
        d = models.pose_net(model_cfg).eval()
        x = torch.empty((batch, 3, h, w))

    def run():
        with torch.no_grad():
            d(x)
            d(x.flip(3))

    return _count(run)


def decode_bytes(batch: int, joints: int, h: int, w: int) -> int:
    """The decode kernel's least traffic: f32 heatmaps read once, (x, y)
    and the maximum written once per map."""
    maps = batch * joints
    return maps * h * w * 4 + maps * 3 * 4


def mfu_pct(flops: float, seconds: float) -> float:
    return 100.0 * flops / seconds / PEAKS["bf16_flops"]


def hbm_roofline_pct(nbytes: float, seconds: float) -> float:
    return 100.0 * (nbytes / PEAKS["hbm_bytes_per_s"]) / seconds
