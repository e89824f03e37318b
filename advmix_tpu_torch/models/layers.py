"""Shared building blocks (NCHW).

Port of `advmix_tpu/models/layers.py`. Modules carry the reference's torch
names, so a reference `.pth` loads with `load_state_dict(strict=True)`.

Compute dtype (bf16 per TRAIN.DTYPE). A convolution computes in the dtype of
its input and casts its weight to it on the way, so the dtype a model runs
in is the dtype its `forward` casts the input to (`compute_dtype_of`).
`set_compute_dtype` sets it in one of two ways: for a frozen model (eval,
the KD teacher) it casts the convolutions' and linears' parameters once; for a model
under training it leaves every parameter f32, the master copy the optimizer
updates, and only records the dtype (flax `dtype` without `param_dtype`,
`layers.py:125-134`). BatchNorm and InstanceNorm keep their statistics and
arithmetic in at least f32 and hand the input's dtype on, as the JAX
`TorchBatchNorm` does (`layers.py:57-83`). `Linear` computes in its input's
dtype as `Conv2d` does, and `LayerNorm` normalizes in at least f32 and hands
the input's dtype on, as `BatchNorm2d` does.

Stochastic depth (`DropPath`) draws no random numbers from torch's
generators: its per-sample keep masks are a hash of a step counter that the
owning model keeps on the device and of the call's slot
(`drop_path_scales`), in integer torch ops that give the same bits on the
CPU and on a card, so that a replayed CUDA graph draws new masks (the
counter advances in place) and a plain reference can draw the same ones.

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


class Linear(nn.Linear):
    """Linear layer in its input's dtype, as `Conv2d`: an f32 master
    weight and bias are cast to a bf16 input's dtype per call."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, _cast(self.weight, x.dtype),
                        _cast(self.bias, x.dtype))


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last dimension (eps 1e-6 by default, HRFormer's)
    that normalizes a bf16 input in f32 and casts the result back to the
    input's dtype, as `BatchNorm2d`."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__(dim, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(torch.float32, x.dtype)
        return F.layer_norm(x.to(dt), self.normalized_shape,
                            _cast(self.weight, dt), _cast(self.bias, dt),
                            self.eps).to(x.dtype)


_M32 = 0xFFFFFFFF
KEEP_BITS = 24  # a keep mask compares 24 hashed bits with a threshold


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finalizer on int64 values in [0, 2^32): two
    xor-shift-multiply rounds. Each product stays below 2^63 (multipliers
    under 2^31), so no operation overflows and the CPU and CUDA give the
    same bits."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


def drop_path_threshold(rate: float) -> int:
    """The integer a slot's 24 hashed bits must reach to keep a sample:
    round(rate x 2^24), so a sample is kept with probability 1 - rate to
    within 2^-24."""
    return int(round(float(rate) * (1 << KEEP_BITS)))


def drop_path_scales(step: torch.Tensor, thresholds: torch.Tensor,
                     batch: int) -> torch.Tensor:
    """(slots, batch) f32 per-sample factors of the DropPath calls of one
    forward: 0 for a dropped sample, 2^24 / (2^24 - threshold) (the
    inverse of the keep rate) for a kept one. Sample n of slot l is kept
    when the top 24 of 32 hashed bits of (step, l, n) reach thresholds[l].
    `step` is a 0-d int64 counter, `thresholds` (slots,) int64, both on the
    model's device; everything stays there, so a CUDA graph captures it."""
    dev = thresholds.device
    slot = torch.arange(thresholds.numel(), device=dev, dtype=torch.int64)
    n = torch.arange(batch, device=dev, dtype=torch.int64)
    h = _mix32(step & _M32)
    h = _mix32((h + slot[:, None] * 0x9E3779B1) & _M32)
    h = _mix32((h + n[None, :]) & _M32)
    keep = (h >> (32 - KEEP_BITS)) >= thresholds[:, None]
    inv = float(1 << KEEP_BITS) / ((1 << KEEP_BITS) - thresholds).to(
        torch.float32)
    return keep.to(torch.float32) * inv[:, None]


class DropPath(nn.Module):
    """Stochastic depth of one block's residual branches, rate `rate`:
    call `c` of the block scales each sample by row `slot + c` of
    `scales`, the (slots, batch) factors that the owning model sets for the
    length of a train-mode forward (`drop_path_scales`); the identity when
    none are set (eval) or at rate 0. Holds no state."""

    def __init__(self, rate: float, slot: int):
        super().__init__()
        self.rate, self.slot = float(rate), int(slot)
        self.scales = None

    def forward(self, x: torch.Tensor, call: int = 0) -> torch.Tensor:
        if self.scales is None or self.rate == 0.0:
            return x
        s = self.scales[self.slot + call].to(x.dtype)
        return x * s.view(-1, *([1] * (x.dim() - 1)))


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
    """Make `model` compute its convolutions and linears in `dtype`; norms
    (and tables such as attention biases) stay f32.

    `trainable=False` is for a frozen model only (eval, the KD teacher):
    the convolutions' and linears' parameters themselves are cast to
    `dtype`, once, and
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
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            m.to(dtype)
    return model.requires_grad_(False)


def compute_dtype_of(model: nn.Module, first_conv: nn.Module) -> torch.dtype:
    """The dtype `model.forward` casts its input to: the one recorded by
    `set_compute_dtype(..., trainable=True)`, else the first convolution's
    parameter dtype."""
    dt = getattr(model, "compute_dtype", None)
    return first_conv.weight.dtype if dt is None else dt
