"""Pairwise OKS matrices for OKS-NMS.

Counterparts of the two Pallas TPU kernels of
`advmix_tpu/ops/pallas/oks_kernel.py`: `oks_matrix_batched` for
`oks_matrix_batched_pallas` (M images of P candidates in one launch) and
`oks_matrix` for `oks_matrix_pallas` (one image of N candidates). Both
launch the one CUDA kernel of `advmix_tpu_torch/csrc/oks.cu` for CUDA
tensors, and use `oks_matrix_batched_plain`, the same function in plain
PyTorch, only for tensors on the CPU. Each keeps its own launch count.

S[m,i,k] = (1/J) * sum_j exp(-|p_ij - p_kj|^2 * invvar_j * 0.5
                             / ((a_i + a_k)/2 + eps)),
invvar = 1/(2 sigma)^2 with the COCO sigmas, eps = np.spacing(1), as the
Pallas body computes it (`oks_kernel.py:38,56`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..nms import COCO_SIGMAS
from .build import MAX_JOINTS, InvVar, check_cuda_tensor, check_status, \
    library

EPS = 2.220446049250313e-16
MAX_IMAGES = 65535  # CUDA's limit on grid z


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


def _launch(kpts: torch.Tensor, areas: torch.Tensor, sigmas,
            wrapper) -> torch.Tensor:
    """Check the inputs, launch the kernel, count it on `wrapper`."""
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
    invvar = InvVar()
    invvar.v[:j] = _invvar(sigmas, j).tolist()
    out = torch.empty((m, p, p), dtype=torch.float32, device=kpts.device)
    if m * p == 0:
        return out
    lib = library()
    with torch.cuda.device(kpts.device):
        stream = torch.cuda.current_stream(kpts.device).cuda_stream
        rc = lib.advmix_oks_matrix(
            kpts.data_ptr(), areas.data_ptr(), invvar, out.data_ptr(), m, p,
            j, _inv_j(j), stream)
    check_status("oks_matrix", rc)
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
