"""The int8 convolution of the W8A8 path (`ops/quant.py`): the custom op
`advmix_tpu_torch::int8_conv2d`, (int8 input codes NCHW, int8 weight OIHW,
stride, padding) -> int32 sums NHWC:
- on a CPU tensor an exact float64 convolution of the codes (every sum
  stays below 2^53), cast to int32;
- on a CUDA tensor an im2col of the int8 codes (`F.pad` and
  `Tensor.unfold` views, one contiguous (B*Ho*Wo, kh*kw*Cin) copy; a 1x1
  stride-1 convolution is only the channels-last reshape), then
  `torch._int_mm`, integer cuBLASLt with an exact int32 sum. Its rules in
  torch 2.11 on the H100: more than 16 rows and a depth and width that
  are multiples of 8 (torch's own checks); and at depth 32 and width 64
  cuBLASLt took 32, 64 and 96 rows but refused 17, 20, 24, 33 and 48 with
  CUBLAS_STATUS_NOT_SUPPORTED (`chip_smoke.py` phase 13a logs this). The
  operands are padded with zero rows to a multiple of 32
  (`INT_MM_ROW_MULTIPLE`) and zero columns to a multiple of 8
  (`INT_MM_MULTIPLE`), so the stem's depth 27 (3x3x3) becomes 32.
  No float convolution of the codes runs on the card: a 3x3x256 sum of
  127*127 products reaches 3.7e7, beyond f32's 2^24.
A fake implementation gives `torch.export` the output's shape.

Counterpart of the XLA convolution with an int32 result in
`advmix_tpu/ops/quant.py:_quantized_conv` (`lax.conv_general_dilated(...,
preferred_element_type=jnp.int32)`), not of a Pallas kernel. This module
imports no model code, so a server that loads an exported program needs
only it and `ops/cuda/decode_kernel.py` for the ops' registrations.
`int8_conv2d.launches` counts the GEMMs launched on the card.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

# torch._int_mm on CUDA: depth and width multiples of 8; rows padded to a
# multiple of 32, which cuBLASLt takes
INT_MM_ROW_MULTIPLE = 32
INT_MM_MULTIPLE = 8


def _out_hw(h: int, w: int, kh: int, kw: int, stride, padding):
    return ((h + 2 * padding[0] - kh) // stride[0] + 1,
            (w + 2 * padding[1] - kw) // stride[1] + 1)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def im2col_nhwc(xq: torch.Tensor, kh: int, kw: int, stride: Sequence[int],
                padding: Sequence[int]) -> torch.Tensor:
    """(B, C, H, W) codes -> the (B*Ho*Wo, kh*kw*C) matrix of their
    receptive fields, columns ordered (kh, kw, C). `F.unfold` takes no
    int8, so this is `F.pad` and two `Tensor.unfold` views over H and W,
    then one contiguous copy."""
    b, c = xq.shape[:2]
    x = xq.permute(0, 2, 3, 1)  # NHWC view
    if kh == 1 and kw == 1 and tuple(stride) == (1, 1) \
            and tuple(padding) == (0, 0):
        return x.reshape(-1, c)  # the channels-last copy only
    if padding[0] or padding[1]:
        x = F.pad(x, (0, 0, padding[1], padding[1], padding[0], padding[0]))
    # (B, Ho, Wo, C, kh, kw) -> (B, Ho, Wo, kh, kw, C)
    win = x.unfold(1, kh, stride[0]).unfold(2, kw, stride[1])
    ho, wo = win.shape[1], win.shape[2]
    return win.permute(0, 1, 2, 4, 5, 3).reshape(b * ho * wo, kh * kw * c)


def weight_matrix(wq: torch.Tensor) -> torch.Tensor:
    """OIHW codes -> the (kh*kw*I, O) GEMM operand, rows ordered as the
    columns of `im2col_nhwc`."""
    o = wq.shape[0]
    return wq.permute(2, 3, 1, 0).reshape(-1, o)


def int_mm_padded(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) int8 @ b (K, N) int8 -> (M, N) int32 through
    `torch._int_mm`, with zero rows and columns added to meet its shape
    rules on CUDA and sliced off again."""
    m, k = a.shape
    n = b.shape[1]
    mp = _round_up(m, INT_MM_ROW_MULTIPLE)
    kp = _round_up(k, INT_MM_MULTIPLE)
    np_ = _round_up(n, INT_MM_MULTIPLE)
    if kp != k or mp != m:
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if kp != k or np_ != n:
        b = F.pad(b, (0, np_ - n, 0, kp - k))
    out = torch._int_mm(a.contiguous(), b.contiguous())
    if mp != m or np_ != n:
        out = out[:m, :n]
    return out


@torch.library.custom_op("advmix_tpu_torch::int8_conv2d", mutates_args=())
def int8_conv2d(xq: torch.Tensor, wq: torch.Tensor, stride: list[int],
                padding: list[int]) -> torch.Tensor:
    """int8 codes (B, C, H, W) * int8 weight (O, C, kh, kw) -> exact int32
    sums (B, Ho, Wo, O). On the CPU a float64 convolution of the codes."""
    if xq.device.type != "cpu":
        raise RuntimeError(f"int8_conv2d: no route for a {xq.device.type} "
                           "tensor")
    acc = F.conv2d(xq.to(torch.float64), wq.to(torch.float64),
                   stride=tuple(stride), padding=tuple(padding))
    return acc.permute(0, 2, 3, 1).to(torch.int32).contiguous()


@int8_conv2d.register_kernel("cuda")
def _int8_conv2d_cuda(xq, wq, stride, padding):
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"int8_conv2d takes int8 codes, got {xq.dtype}, "
                        f"{wq.dtype}")
    b, _, h, w = xq.shape
    o, _, kh, kw = wq.shape
    ho, wo = _out_hw(h, w, kh, kw, stride, padding)
    cols = im2col_nhwc(xq, kh, kw, stride, padding)
    acc = int_mm_padded(cols, weight_matrix(wq))
    int8_conv2d.launches += 1
    return acc.reshape(b, ho, wo, o)


@int8_conv2d.register_fake
def _int8_conv2d_fake(xq, wq, stride, padding):
    b, _, h, w = xq.shape
    o, _, kh, kw = wq.shape
    ho, wo = _out_hw(h, w, kh, kw, stride, padding)
    return xq.new_empty((b, ho, wo, o), dtype=torch.int32)


int8_conv2d.launches = 0
