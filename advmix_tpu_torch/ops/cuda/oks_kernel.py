"""Pairwise OKS matrices for OKS-NMS.

Counterparts of the two Pallas TPU kernels of
`advmix_tpu/ops/pallas/oks_kernel.py`: `oks_matrix_batched` for
`oks_matrix_batched_pallas` (M images of P candidates in one launch) and
`oks_matrix` for `oks_matrix_pallas` (one image of N candidates). Both
launch the one CUDA kernel of `advmix_tpu_torch/csrc/oks.cu` for CUDA
tensors, and use `oks_matrix_batched_plain`, the same function in plain
PyTorch, only for tensors on the CPU. Each keeps its own launch count. The
kernel computes the tiles on and above the diagonal and mirrors them;
`oks_micro` chooses its tile size from the shape before the launch.

S[m,i,k] = (1/J) * sum_j exp(-|p_ij - p_kj|^2 * invvar_j * 0.5
                             / ((a_i + a_k)/2 + eps)),
invvar = 1/(2 sigma)^2 with the COCO sigmas, eps = np.spacing(1), as the
Pallas body computes it (`oks_kernel.py:38,56`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..nms import COCO_SIGMAS
from .build import check_cuda_tensor, check_status, library

EPS = 2.220446049250313e-16
MAX_IMAGES = 65535  # CUDA's limit on grid y
MAX_JOINTS = 128  # keeps a block's staged points within shared memory


def _invvar(sigmas, j: int) -> np.ndarray:
    """1/(2 sigma)^2 in f32, each step rounded as the Pallas wrapper's f32
    arithmetic rounds it."""
    sig = np.asarray(COCO_SIGMAS if sigmas is None else sigmas, np.float32)
    if sig.shape != (j,):
        raise ValueError(f"need {j} sigmas, got {sig.shape}")
    return np.float32(1.0) / ((sig * np.float32(2.0)) ** 2)


def _inv_j(j: int) -> float:
    return float(np.float32(1.0 / j))


def oks_matrix_batched_plain(kpts: torch.Tensor, areas: torch.Tensor,
                             sigmas=None) -> torch.Tensor:
    """The OKS kernel's function in plain PyTorch: kpts (M, P, J, 2) f32,
    areas (M, P) -> (M, P, P) f32, summing over J in the kernel's order."""
    j = kpts.shape[2]
    invvar = torch.from_numpy(_invvar(sigmas, j)).to(kpts.device)
    denom = (areas[:, :, None] + areas[:, None, :]) * 0.5 + EPS
    inv_denom = 0.5 / denom
    acc = torch.zeros_like(inv_denom)
    for jj in range(j):
        x = kpts[:, :, jj, 0]
        y = kpts[:, :, jj, 1]
        dx = x[:, :, None] - x[:, None, :]
        dy = y[:, :, None] - y[:, None, :]
        e = (dx * dx + dy * dy) * (invvar[jj] * inv_denom)
        acc = acc + torch.exp(-e)
    return acc * _inv_j(j)


@functools.lru_cache(maxsize=16)
def _invvar_on(device: torch.device, sigmas: tuple | None,
               j: int) -> torch.Tensor:
    """The 1/(2 sigma)^2 table on `device`, copied there once per table so
    that a launch copies nothing."""
    table = torch.from_numpy(_invvar(sigmas, j)).to(device)
    torch.cuda.current_stream(device).synchronize()
    return table


def oks_micro(m: int, p: int, sms: int) -> int:
    """Side of the micro-tile each thread computes (a tile is 16
    micro-tiles wide), chosen from the shape and the card's SM count: the
    largest of 4, 2, 1 whose tile is no wider than the matrix and whose
    grid of upper-triangular tiles still has two blocks for every SM.
    Larger micro-tiles reuse each staged value more (4 is fastest at
    M=4096 with P=64 or 128, 2 at M=1600 P=32); a small grid is spread over
    more, smaller blocks instead (1 is fastest at M=47 P=32 and N=130)."""
    for micro in (4, 2):
        tile = 16 * micro
        tiles = -(-p // tile)
        if tile <= p and m * tiles * (tiles + 1) // 2 >= 2 * sms:
            return micro
    return 1


def _launch(kpts: torch.Tensor, areas: torch.Tensor, sigmas, wrapper,
            micro: int | None = None) -> torch.Tensor:
    """Check the inputs, launch the kernel, count it on `wrapper` (if one
    is given). `micro` overrides `oks_micro`'s choice; only timing scripts
    pass it."""
    check_cuda_tensor("kpts", kpts, torch.float32, 4)
    check_cuda_tensor("areas", areas, torch.float32, 2)
    m, p, j, two = kpts.shape
    if two != 2 or areas.shape != (m, p) or areas.device != kpts.device:
        raise ValueError(f"kpts {tuple(kpts.shape)} / areas "
                         f"{tuple(areas.shape)} do not form (M, P, J, 2) / "
                         "(M, P) on one device")
    if not 0 < j <= MAX_JOINTS or m > MAX_IMAGES:
        raise ValueError(f"J={j} must be in 1..{MAX_JOINTS} and M={m} at "
                         f"most {MAX_IMAGES}")
    out = torch.empty((m, p, p), dtype=torch.float32, device=kpts.device)
    if m * p == 0:
        return out
    if kpts.data_ptr() % 8:
        # the kernel loads (x, y) pairs as 8-byte values; a view at an odd
        # storage offset is copied to an aligned buffer first
        kpts = kpts.clone()
    invvar = _invvar_on(kpts.device,
                        None if sigmas is None else tuple(
                            float(s) for s in np.ravel(sigmas)), j)
    if micro is None:
        micro = oks_micro(m, p, torch.cuda.get_device_properties(
            kpts.device).multi_processor_count)
    lib = library()
    with torch.cuda.device(kpts.device):
        stream = torch.cuda.current_stream(kpts.device).cuda_stream
        rc = lib.advmix_oks_matrix(
            kpts.data_ptr(), areas.data_ptr(), invvar.data_ptr(),
            out.data_ptr(), m, p, j, _inv_j(j),
            micro, stream)
    check_status("oks_matrix", rc)
    if wrapper is not None:
        wrapper.launches += 1
    return out


def oks_matrix_batched(kpts: torch.Tensor, areas: torch.Tensor,
                       sigmas=None) -> torch.Tensor:
    """Per-image OKS matrices of M images in one launch: kpts
    (M, P, J, 2) f32, areas (M, P) f32 -> (M, P, P) f32."""
    if kpts.device.type == "cpu":
        return oks_matrix_batched_plain(kpts, areas, sigmas)
    return _launch(kpts, areas, sigmas, oks_matrix_batched)


def oks_matrix(kpts: torch.Tensor, areas: torch.Tensor,
               sigmas=None) -> torch.Tensor:
    """The (N, N) OKS matrix of one image's candidates: kpts (N, J, 2) f32,
    areas (N,) f32."""
    if kpts.device.type == "cpu":
        return oks_matrix_batched_plain(kpts[None], areas[None], sigmas)[0]
    return _launch(kpts[None], areas[None], sigmas, oks_matrix)[0]


oks_matrix_batched.launches = 0
oks_matrix.launches = 0
