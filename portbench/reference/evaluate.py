"""The reference top-down eval of one batch, in plain PyTorch, and the
judgement of the program's answers against it.

HRNet's `lib/core/function.py:validate` with TEST.FLIP_TEST,
SHIFT_HEATMAP and POST_PROCESS: the heatmaps of the image and of its mirror
(flipped back, left and right joints swapped, shifted one pixel right) are
averaged; each map's first row-major maximum is moved a quarter pixel toward
its larger neighbour on each axis when it lies strictly inside; the point
goes back to the image through the box (`transform_preds`, no rotation).
"""

from __future__ import annotations

import torch

from . import corruptions

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def corrupted(image_u8: torch.Tensor, name: str, severity: int):
    """The sweep's on-the-fly input: uint8 NHWC crops as f32, corrupted in
    the exact-render form with a generator seeded 1 on their device."""
    x = image_u8.to(torch.float32)
    if name in (None, "", "clean"):
        return x
    g = torch.Generator(x.device).manual_seed(1)
    return corruptions.corrupt(x, name, severity, g, exact_render=True)


def heatmaps(model, image_f32_nhwc, flip_pairs):
    """Flip-averaged f32 heatmaps (B, J, H, W)."""
    mean = torch.tensor(IMAGENET_MEAN, device=image_f32_nhwc.device) * 255.0
    std = torch.tensor(IMAGENET_STD, device=image_f32_nhwc.device) * 255.0
    x = ((image_f32_nhwc - mean) / std).permute(0, 3, 1, 2)
    with torch.no_grad():
        out = model(x)
        f = model(x.flip(3)).flip(3)
        perm = list(range(f.shape[1]))
        for a, b in flip_pairs:
            perm[a], perm[b] = perm[b], perm[a]
        f = f[:, perm]
        f = torch.cat([f[..., :1], f[..., :-1]], dim=3)
        return ((out + f) * 0.5).to(torch.float32)


def refine(flat, px, py, h, w):
    """POST_PROCESS: (px, py) moved a quarter pixel toward the larger
    neighbour on each axis where strictly inside; f64 (..., 2)."""
    inside = (px > 1) & (px < w - 1) & (py > 1) & (py < h - 1)

    def at(yy, xx):
        i = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1))
        return flat.gather(2, i[..., None])[..., 0]

    dx = torch.sign(at(py, px + 1) - at(py, px - 1)) * 0.25
    dy = torch.sign(at(py + 1, px) - at(py - 1, px)) * 0.25
    x = px.to(torch.float64) + torch.where(inside, dx, 0).to(torch.float64)
    y = py.to(torch.float64) + torch.where(inside, dy, 0).to(torch.float64)
    return torch.stack([x, y], -1)


def decode(hm):
    """(B, J, H, W) -> heatmap coords (B, J, 2) and maxima (B, J)."""
    b, j, h, w = hm.shape
    flat = hm.reshape(b, j, h * w)
    m = flat.amax(-1)
    iota = torch.arange(h * w, device=hm.device)
    idx = torch.where(flat == m[..., None], iota, h * w).amin(-1)
    xy = refine(flat, idx % w, idx // w, h, w)
    return xy * (m > 0)[..., None], m


def to_image(xy, center, scale, hw):
    """Heatmap coords -> image coords of the box, as HRNet's affine without
    rotation: one scale, scale[0] * 200 / W, on both axes."""
    h, w = hw
    s = (scale[:, 0].to(torch.float64) * 200.0 / w)[:, None]
    c = center.to(torch.float64)
    return torch.stack([c[:, None, 0] + (xy[..., 0] - w * 0.5) * s,
                        c[:, None, 1] + (xy[..., 1] - h * 0.5) * s], -1)


def to_heatmap(pts, center, scale, hw):
    h, w = hw
    s = (scale[:, 0].to(torch.float64) * 200.0 / w)[:, None]
    c = center.to(torch.float64)
    return torch.stack([(pts[..., 0] - c[:, None, 0]) / s + w * 0.5,
                        (pts[..., 1] - c[:, None, 1]) / s + h * 0.5], -1)


def bilinear(hm, xy):
    """Each map of (B, J, H, W) read at its (x, y), clamped to the map."""
    b, j, h, w = hm.shape
    x = xy[..., 0].clamp(0, w - 1)
    y = xy[..., 1].clamp(0, h - 1)
    x0 = x.floor().clamp(max=w - 2)
    y0 = y.floor().clamp(max=h - 2)
    fx, fy = x - x0, y - y0
    flat = hm.reshape(b, j, h * w).to(torch.float64)

    def at(yy, xx):
        return flat.gather(2, (yy * w + xx).long()[..., None])[..., 0]

    top = at(y0, x0) * (1 - fx) + at(y0, x0 + 1) * fx
    bot = at(y0 + 1, x0) * (1 - fx) + at(y0 + 1, x0 + 1) * fx
    return top * (1 - fy) + bot * fy


def judge(hm_ref, preds, maxvals, center, scale):
    """The gaps of the program's answers against the reference's heatmaps,
    one per map, each as a share of that reference map's range. The
    program's image point is mapped back through the box; the peak it was
    refined from is that point rounded. `heat`: how far the reference map at
    that peak lies below the reference map's maximum, plus how far the
    reference map read at the program's point lies from the same map read at
    the reference's own refinement of that peak. A near tie that rounding
    resolves the other way, or a quarter-pixel step taken the other way
    where the two neighbours nearly agree, costs little; a wrong peak, a
    wrong refinement or a wrong transform costs much. Where the program's
    maximum is not positive its answer is the origin, as the reference's
    then is: `heat` is how far the reference's maximum lies above zero, plus
    the point's distance from the origin. `maxval`: |program maximum -
    reference maximum|. Returns (heat, maxval), float64 (B, J)."""
    b, j, h, w = hm_ref.shape
    flat = hm_ref.reshape(b, j, h * w)
    m_ref = flat.amax(-1).to(torch.float64)
    rng = (m_ref - flat.amin(-1).to(torch.float64)).clamp(min=1e-12)
    pt = to_heatmap(preds.to(torch.float64), center, scale, (h, w))
    px = pt[..., 0].round().clamp(0, w - 1).long()
    py = pt[..., 1].round().clamp(0, h - 1).long()
    at_peak = flat.gather(2, (py * w + px)[..., None])[..., 0]
    step = (bilinear(hm_ref, pt)
            - bilinear(hm_ref, refine(flat, px, py, h, w))).abs()
    heat = (m_ref - at_peak.to(torch.float64) + step) / rng
    m_prog = maxvals.reshape(b, j).to(torch.float64)
    origin = m_ref.clamp(min=0) / rng + pt.abs().sum(-1)
    heat = torch.where(m_prog > 0, heat, origin)
    mv = (m_prog - m_ref).abs() / rng
    return heat, mv
