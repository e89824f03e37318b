"""Precision of the reference: float32 with TF32 off, or the fp8 control.

The control of the output check computes the reference one precision step
below the configuration's bfloat16: every convolution's input, weight and
output rounded to float8 e4m3 with a per-tensor scale (its absolute maximum
maps to 448, e4m3's largest value), as the program rounds them to bfloat16,
and the gradient that flows back through them rounded to float8 e5m2 with
its own scale, the usual split of fp8 training.
"""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().to(torch.float32)
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return ((x.to(torch.float32) / scale).to(dtype).to(torch.float32)
            * scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def fp8_quant(x: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(x)


@contextlib.contextmanager
def exact_f32():
    """float32 matmuls and convolutions without TF32, for the reference."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
