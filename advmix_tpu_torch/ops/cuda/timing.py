"""Launchers of the yardstick kernels in `advmix_tpu_torch/csrc/timing.cu`
and of the port's kernels with their design choices forced.

Only timing scripts (`chip_smoke.py`) and the card tests call these: the
port's own paths go through `decode_kernel.py` and `oks_kernel.py`, and
nothing here counts as a launch of theirs. Everything needs CUDA tensors.
"""

from __future__ import annotations

import torch

from . import oks_kernel
from .build import InvVar, check_cuda_tensor, check_status, library
from .decode_kernel import ROUTES, decode_route, launch_decode

def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def empty_launch(device) -> None:
    """One launch of a kernel that does nothing."""
    with torch.cuda.device(device):
        check_status("empty", library().advmix_empty_launch(_stream(device)))


def expf_probe(out: torch.Tensor, blocks: int, threads: int,
               iters: int) -> int:
    """blocks x threads threads each sum 4 * iters values of expf into
    `out` (blocks * threads f32). Returns the number of expf evaluated."""
    check_cuda_tensor("out", out, torch.float32, 1)
    if out.numel() != blocks * threads:
        raise ValueError(f"out needs {blocks * threads} values")
    with torch.cuda.device(out.device):
        check_status("expf_probe", library().advmix_expf_probe(
            out.data_ptr(), blocks, threads, iters, _stream(out.device)))
    return blocks * threads * iters * 4


def decode_by(design: str, heatmaps: torch.Tensor, post_process: bool = True):
    """`decode_heatmaps` with the route of csrc/decode.cu forced: "scalar"
    (any maps) or "vector" (H*W % 4 == 0 and a 16-byte aligned base)."""
    if design == "vector" and decode_route(
            heatmaps.shape[-2], heatmaps.shape[-1],
            heatmaps.data_ptr()) != "vector":
        raise ValueError("the vector route needs 16-byte aligned maps")
    return launch_decode(ROUTES[design], heatmaps, post_process)[:2]


def oks_by_micro(kpts: torch.Tensor, areas: torch.Tensor,
                 micro: int) -> torch.Tensor:
    """`oks_matrix_batched` with the micro-tile side forced to 1, 2 or 4."""
    return oks_kernel._launch(kpts, areas, None, None, micro)


def oks_baseline(kpts: torch.Tensor, areas: torch.Tensor) -> torch.Tensor:
    """`oks_matrix_batched` by the baseline kernel of csrc/timing.cu (one
    entry per thread, the full square computed)."""
    check_cuda_tensor("kpts", kpts, torch.float32, 4)
    check_cuda_tensor("areas", areas, torch.float32, 2)
    m, p, j, _ = kpts.shape
    invvar = InvVar()
    invvar.v[:j] = oks_kernel._invvar(None, j).tolist()
    out = torch.empty((m, p, p), dtype=torch.float32, device=kpts.device)
    with torch.cuda.device(kpts.device):
        rc = library().advmix_oks_matrix_baseline(
            kpts.data_ptr(), areas.data_ptr(), invvar, out.data_ptr(), m, p,
            j, oks_kernel._inv_j(j), _stream(kpts.device))
    check_status("oks baseline", rc)
    return out
