"""The frozen copies in `portbench/reference/` against computations of the
same semantics written apart from them, so that a fault of the program at
the time it was copied would show here: the bilinear inverse warp against
torch's `grid_sample` on matrices inverted and pixels mapped in float64."""

from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F

from portbench.reference import warp


def plain_warp(images, mats, out_size, fill_value=0.0):
    """Destination pixel (x, y) samples the source at inv(M) (x, y, 1),
    bilinearly, with `fill_value` outside the source (cv2.warpAffine
    INTER_LINEAR, BORDER_CONSTANT), in float64."""
    out_w, out_h = out_size
    b, hs, ws, _ = images.shape
    m = mats.to(torch.float64)
    last = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64)
    inv = torch.linalg.inv(torch.cat([m, last.expand(b, 1, 3)], dim=1))
    gy, gx = torch.meshgrid(torch.arange(out_h, dtype=torch.float64),
                            torch.arange(out_w, dtype=torch.float64),
                            indexing="ij")
    pts = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    src = torch.einsum("bij,hwj->bhwi", inv[:, :2], pts)
    grid = torch.stack([src[..., 0] * (2.0 / (ws - 1)) - 1.0,
                        src[..., 1] * (2.0 / (hs - 1)) - 1.0], dim=-1)
    x = images.permute(0, 3, 1, 2).to(torch.float64) - fill_value
    out = F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                        align_corners=True) + fill_value
    return out.permute(0, 2, 3, 1)


def _crop_matrices(b, g):
    """Rotations, scales and shifts that move part of each crop off the
    source, as the training boxes do."""
    ang = torch.rand(b, generator=g, dtype=torch.float64) * 3.0 - 1.5
    s = 0.5 + torch.rand(b, generator=g, dtype=torch.float64)
    t = torch.rand(b, 2, generator=g, dtype=torch.float64) * 40.0 - 15.0
    c, n = s * torch.cos(ang), s * torch.sin(ang)
    return torch.stack([torch.stack([c, -n, t[:, 0]], -1),
                        torch.stack([n, c, t[:, 1]], -1)], 1).float()


@pytest.mark.parametrize("fill", [0.0, 7.5])
def test_warp_matches_a_plain_bilinear_warp(fill):
    g = torch.Generator().manual_seed(0)
    img = torch.randint(0, 256, (6, 120, 160, 3), generator=g,
                        dtype=torch.uint8)
    mats = _crop_matrices(6, g)
    got = warp.warp_affine(img, mats, (48, 64), fill)
    want = plain_warp(img, mats, (48, 64), fill)
    assert got.dtype == torch.float32 and got.shape == (6, 64, 48, 3)
    # float32 source coordinates: a few thousandths of a level at most
    err = (got.double() - want).abs()
    assert float(err.max()) < 0.01, float(err.max())
    assert float(err.mean()) < 1e-3
    # the fill shows where a crop leaves the source
    assert bool((got == fill).any())
