"""Fused heatmap decode: argmax + quarter-pixel offset + mask.

Counterpart of the Pallas TPU kernel
`advmix_tpu/ops/pallas/decode_kernel.py:decode_heatmaps_pallas`; the CUDA
kernel is `advmix_tpu_torch/csrc/decode.cu`. `decode_heatmaps` launches it
for a CUDA tensor and uses `decode_heatmaps_plain`, the same function in
plain PyTorch, only for a tensor on the CPU. The source has two routes, and
`decode_route` chooses one from the arguments before the launch.

`decode_heatmaps` calls the custom op `advmix_tpu_torch::decode_heatmaps`
(`torch.library.custom_op`): its CUDA implementation launches the kernel,
its CPU implementation is the plain version, and its fake implementation
gives `torch.export` the output shapes, so an exported program (the
serving path, `tools/export.py`) keeps the launch as one node and
`decode_heatmaps.launches` counts the launches made from inside it too.
"""

from __future__ import annotations

import torch

from ..heatmap import argmax_first
from .build import check_cuda_tensor, check_status, library


def decode_heatmaps_plain(heatmaps: torch.Tensor, post_process: bool = True):
    """The decode kernel's function in plain PyTorch.

    heatmaps (B, J, H, W) f32 -> coords (B, J, 2) in heatmap space and
    maxvals (B, J, 1). Per map: the first row-major maximum; with
    post_process and the peak strictly inside (1 < px < W-1, 1 < py < H-1),
    a 0.25 shift toward the larger horizontal / vertical neighbour; coords
    zeroed where the maximum is not positive, after the shift (as
    `decode_kernel.py:41-61` orders it)."""
    b, j, h, w = heatmaps.shape
    flat = heatmaps.reshape(b, j, h * w)
    maxvals, idx = argmax_first(flat)
    py = torch.div(idx, w, rounding_mode="floor")
    px = idx - py * w
    x = px.to(torch.float32)
    y = py.to(torch.float32)
    if post_process:
        inside = (px > 1) & (px < w - 1) & (py > 1) & (py < h - 1)
        pxc = px.clamp(1, w - 2)
        pyc = py.clamp(1, h - 2)

        def at(yy, xx):
            # clamped so a peak off the interior (masked below) stays in
            # bounds
            i = (yy * w + xx).clamp(0, h * w - 1)
            return torch.gather(flat, 2, i[..., None])[..., 0]

        dx = at(pyc, pxc + 1) - at(pyc, pxc - 1)
        dy = at(pyc + 1, pxc) - at(pyc - 1, pxc)
        x = x + torch.where(inside, torch.sign(dx) * 0.25, 0.0)
        y = y + torch.where(inside, torch.sign(dy) * 0.25, 0.0)
    valid = maxvals[..., 0] > 0.0
    coords = torch.stack([torch.where(valid, x, 0.0),
                          torch.where(valid, y, 0.0)], dim=-1)
    return coords, maxvals


ROUTES = {"scalar": 0, "vector": 1}


def decode_route(h: int, w: int, data_ptr: int) -> str:
    """The kernel route for (.., H, W) f32 maps stored contiguously from
    address `data_ptr`: "vector" (16-byte loads, one warp per map) when a
    map is a whole number of 16-byte values and the base is 16-byte
    aligned, else "scalar" (4-byte loads, one block per map). A contiguous
    view with a storage offset, `torch.empty(n + 1)[1:]`, is not aligned."""
    if (h * w) % 4 == 0 and data_ptr % 16 == 0:
        return "vector"
    return "scalar"


def launch_decode(route: int, heatmaps: torch.Tensor, post_process: bool):
    """Check (B, J, H, W) f32 CUDA heatmaps, allocate coords (B, J, 2) and
    maxvals (B, J, 1), and launch the kernel by route number `route`.
    Returns (coords, maxvals, launched): nothing is launched for an empty
    batch."""
    check_cuda_tensor("heatmaps", heatmaps, torch.float32, 4)
    b, j, h, w = heatmaps.shape
    if h * w == 0:
        raise ValueError(f"heatmaps {tuple(heatmaps.shape)} have no pixels")
    coords = torch.empty((b, j, 2), dtype=torch.float32,
                         device=heatmaps.device)
    maxvals = torch.empty((b, j, 1), dtype=torch.float32,
                          device=heatmaps.device)
    if b * j == 0:
        return coords, maxvals, False
    lib = library()
    with torch.cuda.device(heatmaps.device):
        stream = torch.cuda.current_stream(heatmaps.device).cuda_stream
        rc = lib.advmix_decode_heatmaps(
            heatmaps.data_ptr(), coords.data_ptr(), maxvals.data_ptr(),
            b * j, h, w, int(bool(post_process)), route, stream)
    check_status("decode_heatmaps", rc)
    return coords, maxvals, True


@torch.library.custom_op("advmix_tpu_torch::decode_heatmaps",
                        mutates_args=())
def _decode_op(heatmaps: torch.Tensor,
               post_process: bool) -> tuple[torch.Tensor, torch.Tensor]:
    if heatmaps.device.type != "cpu":
        raise RuntimeError(f"decode_heatmaps: no kernel for a "
                           f"{heatmaps.device.type} tensor")
    return decode_heatmaps_plain(heatmaps, post_process)


@_decode_op.register_kernel("cuda")
def _decode_cuda(heatmaps, post_process):
    # an exported program calls the op itself, and may hand over the maps
    # in another layout than the eager step's
    heatmaps = heatmaps.contiguous()
    check_cuda_tensor("heatmaps", heatmaps, torch.float32, 4)
    route = decode_route(heatmaps.shape[-2], heatmaps.shape[-1],
                         heatmaps.data_ptr())
    coords, maxvals, launched = launch_decode(ROUTES[route], heatmaps,
                                              post_process)
    decode_heatmaps.launches += int(launched)
    return coords, maxvals


@_decode_op.register_fake
def _decode_fake(heatmaps, post_process):
    b, j = heatmaps.shape[:2]
    return (heatmaps.new_empty((b, j, 2)), heatmaps.new_empty((b, j, 1)))


def decode_heatmaps(heatmaps: torch.Tensor, post_process: bool = True):
    """Decode (B, J, H, W) f32 heatmaps: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor. Returns coords (B, J, 2)
    and maxvals (B, J, 1). Any other tensor raises."""
    if heatmaps.device.type not in ("cpu", "cuda"):
        raise ValueError(f"heatmaps must be a CPU or CUDA tensor, got "
                         f"{heatmaps.device}")
    return torch.ops.advmix_tpu_torch.decode_heatmaps(heatmaps,
                                                     bool(post_process))


decode_heatmaps.launches = 0
