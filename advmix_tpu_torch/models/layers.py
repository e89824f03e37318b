"""Shared building blocks (NCHW).

Port of `advmix_tpu/models/layers.py`. Modules carry the reference's torch
names, so a reference `.pth` loads with `load_state_dict(strict=True)`.
Parameters stay f32; `set_compute_dtype` casts the convolutions to a
compute dtype (bf16 per TRAIN.DTYPE), while BatchNorm keeps its statistics
and arithmetic in at least f32, as the JAX `TorchBatchNorm` does
(`layers.py:57-60`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_MOMENTUM = 0.1  # reference BN_MOMENTUM (lib/models/pose_resnet.py:18)


class BatchNorm2d(nn.BatchNorm2d):
    """torch BatchNorm (eps 1e-5, momentum 0.1) that normalizes a bf16
    input in f32 and casts the result back to the input's dtype."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(torch.float32, x.dtype)
        return super().forward(x.to(dt)).to(x.dtype)


def conv(cin: int, cout: int, kernel: int, stride: int = 1,
         padding: int = 0, bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride, padding, bias=bias)


class UpsampleNearest(nn.Module):
    """Integer-factor nearest-neighbour upsampling (HRNet fuse layers)."""

    def __init__(self, factor: int):
        super().__init__()
        self.factor = int(factor)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.interpolate(x, scale_factor=self.factor, mode="nearest")


def set_compute_dtype(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every (transposed) convolution to `dtype`; BatchNorm stays f32.
    The model casts its input to the first convolution's dtype and its
    output back to at least f32."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            m.to(dtype)
    return model
