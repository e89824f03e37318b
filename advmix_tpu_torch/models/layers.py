"""Shared building blocks (NCHW).

Port of `advmix_tpu/models/layers.py`. Modules carry the reference's torch
names, so a reference `.pth` loads with `load_state_dict(strict=True)`.

Compute dtype (bf16 per TRAIN.DTYPE). A convolution computes in the dtype of
its input and casts its weight to it on the way, so the dtype a model runs
in is the dtype its `forward` casts the input to (`compute_dtype_of`).
`set_compute_dtype` sets it in one of two ways: for a frozen model (eval,
the KD teacher) it casts the convolutions' parameters once; for a model
under training it leaves every parameter f32, the master copy the optimizer
updates, and only records the dtype (flax `dtype` without `param_dtype`,
`layers.py:125-134`). BatchNorm and InstanceNorm keep their statistics and
arithmetic in at least f32 and hand the input's dtype on, as the JAX
`TorchBatchNorm` does (`layers.py:57-83`).

Cross-replica BatchNorm (TRAIN.CROSS_REPLICA_BN over several ranks): inside
`cross_replica_bn(group)` every train-mode `BatchNorm2d` averages its E[x]
and E[x^2] over the group (or a ("dcn", "data") mesh's ranks) and takes
var = max(E[x^2] - E[x]^2, 0), the JAX `TorchBatchNorm` with an
`axis_name` (`layers.py:60-80, 90-115`).
Outside it, and in eval mode, the statistics are the rank's own.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

BN_MOMENTUM = 0.1  # reference BN_MOMENTUM (lib/models/pose_resnet.py:18)


# the group of `cross_replica_bn`'s scope (None: per-replica statistics)
_BN_GROUP = {"group": None}


@contextlib.contextmanager
def cross_replica_bn(group):
    """Scope in which train-mode `BatchNorm2d` layers compute their batch
    statistics over the ranks of `group` (None: per-replica), as the JAX
    steps wrap their bodies in `cross_replica_bn(axis_name)`."""
    old = _BN_GROUP["group"]
    _BN_GROUP["group"] = group
    try:
        yield
    finally:
        _BN_GROUP["group"] = old


class BatchNorm2d(nn.BatchNorm2d):
    """torch BatchNorm (eps 1e-5, momentum 0.1) that normalizes a bf16
    input in f32 and casts the result back to the input's dtype."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(torch.float32, x.dtype)
        group = _BN_GROUP["group"]
        if group is not None and self.training:
            return self._cross_replica(x.to(dt), group).to(x.dtype)
        return super().forward(x.to(dt)).to(x.dtype)

    def _cross_replica(self, x: torch.Tensor, group) -> torch.Tensor:
        from ..parallel.dist import AllReduceMean, group_size

        n = x.numel() // x.shape[1]
        stats = AllReduceMean.apply(
            torch.stack([x.mean(dim=(0, 2, 3)), (x * x).mean(dim=(0, 2, 3))]),
            group)
        mean, mean2 = stats[0], stats[1]
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        with torch.no_grad():
            n_all = float(n * group_size(group))
            m = self.momentum
            self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
            self.running_var.copy_((1 - m) * self.running_var
                                   + m * var * (n_all / max(n_all - 1.0, 1.0)))
            self.num_batches_tracked.add_(1)
        y = (x - mean[:, None, None]) * torch.rsqrt(var + self.eps)[:, None,
                                                                     None]
        return y * self.weight[:, None, None] + self.bias[:, None, None]


class InstanceNorm2d(nn.InstanceNorm2d):
    """torch InstanceNorm2d(affine=False, eps 1e-5, no running statistics),
    normalized in at least f32 (`layers.py:185-194`)."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, affine=False,
                         track_running_stats=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(torch.float32, x.dtype)
        return super().forward(x.to(dt)).to(x.dtype)


def _cast(p, dtype):
    return None if p is None else p.to(dtype)


class Conv2d(nn.Conv2d):
    """Convolution in its input's dtype: an f32 master weight is cast to a
    bf16 input's dtype per call (a no-op when they agree)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, _cast(self.weight, x.dtype),
                                  _cast(self.bias, x.dtype))


class ConvTranspose2d(nn.ConvTranspose2d):
    """Transposed convolution in its input's dtype, as `Conv2d`."""

    def forward(self, x: torch.Tensor, output_size=None) -> torch.Tensor:
        assert output_size is None
        return F.conv_transpose2d(
            x, _cast(self.weight, x.dtype), _cast(self.bias, x.dtype),
            self.stride, self.padding, self.output_padding, self.groups,
            self.dilation)


def conv(cin: int, cout: int, kernel: int, stride: int = 1,
         padding: int = 0, bias: bool = False) -> Conv2d:
    return Conv2d(cin, cout, kernel, stride, padding, bias=bias)


def conv_transpose(cin: int, cout: int, kernel: int = 4, stride: int = 2,
                   padding: int = 1, output_padding: int = 0,
                   bias: bool = False) -> ConvTranspose2d:
    """torch sizing, out = (in-1)*s - 2p + k + output_padding, which the
    JAX package reproduces with explicit padding (`layers.py:139-166`)."""
    return ConvTranspose2d(cin, cout, kernel, stride, padding, output_padding,
                           bias=bias)


class UpsampleNearest(nn.Module):
    """Integer-factor nearest-neighbour upsampling (HRNet fuse layers)."""

    def __init__(self, factor: int):
        super().__init__()
        self.factor = int(factor)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.interpolate(x, scale_factor=self.factor, mode="nearest")


def set_compute_dtype(model: nn.Module, dtype: torch.dtype,
                      trainable: bool = False) -> nn.Module:
    """Make `model` compute its convolutions in `dtype`; norms stay f32.

    `trainable=False` is for a frozen model only (eval, the KD teacher):
    the convolutions' parameters themselves are cast to `dtype`, once, and
    every parameter stops requiring a gradient, so no optimizer can come to
    update bf16 weights. `trainable=True` is for a model under training: all
    parameters stay f32 and each convolution casts its weight per call.
    Either way the model casts its input to `dtype` and its output back to
    at least f32."""
    if trainable:
        model.compute_dtype = dtype
        return model
    model.compute_dtype = None
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            m.to(dtype)
    return model.requires_grad_(False)


def compute_dtype_of(model: nn.Module, first_conv: nn.Module) -> torch.dtype:
    """The dtype `model.forward` casts its input to: the one recorded by
    `set_compute_dtype(..., trainable=True)`, else the first convolution's
    parameter dtype."""
    dt = getattr(model, "compute_dtype", None)
    return first_conv.weight.dtype if dt is None else dt
