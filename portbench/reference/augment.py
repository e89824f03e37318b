"""AdvMix's 3-view synthesis (AutoAugment's 12 ImageNet sub-policies and
GridMask), a frozen copy for the reference.

Copied from the measured program's `ops/augment.py` when the benchmark was
defined, so that a later change to the program's views is held against the
semantics of that day: the per-sample draws from a `torch.Generator` in the
same order (so one seed gives both sides the same policies, coins, signs and
grid offsets), PIL's integer equalize on the stride-2 histogram the training
path uses, posterize, solarize, invert, sharpness, and GridMask on the
normalized tensor. The reference runs it in float32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# torchvision Normalize constants of the reference (tools/train.py:116)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


# ---------------------------------------------------------------------------
# Pixel ops (PIL-compatible, on [0, 255] float, batched)
# ---------------------------------------------------------------------------

def invert(img: torch.Tensor) -> torch.Tensor:
    return 255.0 - img


def solarize(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """PIL ImageOps.solarize: invert pixels >= threshold. The threshold is
    compared in the image's dtype, as the JAX package's weakly typed
    scalar is."""
    thr = torch.tensor(threshold, dtype=img.dtype, device=img.device)
    return torch.where(torch.floor(img) >= thr, 255.0 - img, img)


def posterize(img: torch.Tensor, bits: int) -> torch.Tensor:
    """PIL ImageOps.posterize: keep the top `bits` bits per channel."""
    shift = float(2 ** (8 - int(bits)))
    return torch.floor(img / shift) * shift


def equalize(img: torch.Tensor, hist_stride: int = 1) -> torch.Tensor:
    """PIL ImageOps.equalize, batched, in PIL's integer arithmetic: per
    (image, channel) a 256-bin histogram, step = (n - hist[last nonzero
    bin]) // 255, lut[i] = (pixels below i + step // 2) // step, and the
    identity where step == 0.

    The JAX package computes the same with one-hot matmuls for the MXU;
    here the histogram is a `scatter_add_` on offset indices and the LUT a
    gather. `hist_stride` > 1 builds the LUT from every `hist_stride`-th
    row and column (the training path uses 2), with n counted on that
    grid; 1 is PIL-exact."""
    b, c, h, w = img.shape
    q = img.floor().clamp(0, 255).to(torch.int64)  # (B, C, H, W)
    qs = q[:, :, ::hist_stride, ::hist_stride].reshape(b * c, -1)
    n = qs.shape[1]
    rows = torch.arange(b * c, device=img.device)[:, None] * 256
    hist = torch.zeros(b * c * 256, dtype=torch.int64, device=img.device)
    hist.scatter_add_(0, (qs + rows).reshape(-1),
                      torch.ones_like(qs).reshape(-1))
    hist = hist.view(b * c, 256)
    idx = torch.arange(256, device=img.device)
    last_nz = torch.where(hist > 0, idx, -1).argmax(dim=1, keepdim=True)
    step = (n - hist.gather(1, last_nz)) // 255  # (BC, 1)
    cum_before = hist.cumsum(1) - hist
    lut = (cum_before + step // 2) // step.clamp(min=1)
    lut = torch.where(step > 0, lut.clamp(0, 255), idx[None, :])
    mapped = lut.gather(1, q.reshape(b * c, h * w))
    return mapped.view(b, c, h, w).to(img.dtype)


def _smooth_filter(img: torch.Tensor) -> torch.Tensor:
    """PIL ImageFilter.SMOOTH: the 3x3 kernel [[1,1,1],[1,5,1],[1,1,1]]/13
    on the interior; PIL leaves the 1-pixel border unchanged."""
    b, c, h, w = img.shape
    k = torch.tensor([[1, 1, 1], [1, 5, 1], [1, 1, 1]], dtype=torch.float32,
                     device=img.device) / 13.0
    sm = F.conv2d(img.reshape(b * c, 1, h, w), k.to(img.dtype)[None, None],
                  padding=1).view(b, c, h, w)
    out = img.clone()
    out[:, :, 1:-1, 1:-1] = sm[:, :, 1:-1, 1:-1]
    return out


def sharpness(img: torch.Tensor, factor) -> torch.Tensor:
    """PIL ImageEnhance.Sharpness: blend(smooth, img, factor); PIL rounds
    the smoothed image to uint8 before blending. `factor` is a float or a
    tensor that broadcasts against `img`."""
    sm = torch.round(_smooth_filter(img)).clamp(0, 255)
    if torch.is_tensor(factor):
        factor = factor.to(img.dtype)
    return (sm + (img - sm) * factor).clamp(0, 255)


# ---------------------------------------------------------------------------
# AutoAugment ImageNet policy (the 12 sub-policies AdvMix uses)
# ---------------------------------------------------------------------------

# (p1, op1, magnitude_idx1, p2, op2, magnitude_idx2) per advaug.py:22-34
_POLICIES = [
    (0.8, "equalize", 8, 0.6, "equalize", 3),
    (0.6, "posterize", 7, 0.6, "posterize", 6),
    (0.4, "equalize", 7, 0.2, "solarize", 4),
    (0.6, "solarize", 3, 0.6, "equalize", 7),
    (0.8, "posterize", 5, 1.0, "equalize", 2),
    (0.6, "equalize", 8, 0.4, "posterize", 6),
    (0.0, "equalize", 7, 0.8, "equalize", 8),
    (0.6, "invert", 4, 1.0, "equalize", 8),
    (0.4, "sharpness", 7, 0.6, "invert", 8),
    (0.4, "equalize", 7, 0.2, "solarize", 4),
    (0.6, "invert", 4, 1.0, "equalize", 8),
    (0.8, "equalize", 8, 0.6, "equalize", 3),
]

# magnitude tables (advaug.py:48-63); only the ops above are needed
_RANGES = {
    "posterize": np.round(np.linspace(8, 4, 10), 0).astype(int),
    "solarize": np.linspace(256, 0, 10),
    "sharpness": np.linspace(0.0, 0.9, 10),
    "equalize": [0] * 10,
    "invert": [0] * 10,
}


def _apply_op(img, op: str, magnitude: float, sign, fast: bool = False):
    if op == "equalize":
        # training path: subsampled histogram
        return equalize(img, hist_stride=2 if fast else 1)
    if op == "invert":
        return invert(img)
    if op == "posterize":
        return posterize(img, int(magnitude))
    if op == "solarize":
        return solarize(img, float(magnitude))
    if op == "sharpness":
        return sharpness(img, 1.0 + float(magnitude) * sign)
    raise ValueError(op)


def _stage_variants(stage: int):
    """The distinct (op, magnitude) variants of stage 0 or 1 of the policy
    table, with each policy's index into them. Variant 0 is the identity
    (taken when the per-sample coin skips the op)."""
    variants = [("identity", 0.0)]
    index = []
    for pol in _POLICIES:
        op, mag_idx = pol[1 + 3 * stage], pol[2 + 3 * stage]
        key = (op, float(_RANGES[op][mag_idx]))
        if key not in variants:
            variants.append(key)
        index.append(variants.index(key))
    return variants, np.array(index)


def _draw(fn, generator: torch.Generator, device, *args, **kwargs):
    """A draw on the generator's own device, moved to `device`: the values
    depend on the generator's seed and not on where the images lie."""
    return fn(*args, generator=generator, device=generator.device,
              **kwargs).to(device)


def draw_autoaugment(b: int, generator: torch.Generator,
                     device=None) -> dict:
    """Per sample: one policy index, two application coins, one magnitude
    sign (+1 or -1)."""
    return dict(
        pol_idx=_draw(torch.randint, generator, device, 0, len(_POLICIES),
                      (b,)),
        u1=_draw(torch.rand, generator, device, b),
        u2=_draw(torch.rand, generator, device, b),
        sign=_draw(torch.randint, generator, device, 0, 2,
                   (b,)).to(torch.float32) * 2.0 - 1.0)


def apply_autoaugment(img: torch.Tensor, pol_idx, u1, u2,
                      sign) -> torch.Tensor:
    """Apply sub-policy `pol_idx[i]` to sample i of `img` (B, 3, H, W) in
    [0, 255]. Each stage computes its few distinct variants once on the
    whole batch (equalize runs once per stage), and a per-sample select
    takes the variant; the identity where the coin u >= the op's p."""
    sign = sign.to(img.dtype)[:, None, None, None]
    probs = torch.tensor([(p[0], p[3]) for p in _POLICIES],
                         dtype=torch.float32, device=img.device)
    out = img
    for stage, coin in ((0, u1), (1, u2)):
        variants, pol_to_variant = _stage_variants(stage)
        vidx = torch.from_numpy(pol_to_variant).to(img.device)[pol_idx]
        vidx = torch.where(coin < probs[:, stage][pol_idx], vidx, 0)
        sel = out
        for v, (op, mag) in enumerate(variants[1:], start=1):
            cand = _apply_op(out, op, mag, sign, fast=True)
            sel = torch.where((vidx == v)[:, None, None, None], cand, sel)
        out = sel
    return out


def autoaugment(img: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    return apply_autoaugment(
        img, **draw_autoaugment(img.shape[0], generator, img.device))


# ---------------------------------------------------------------------------
# GridMask (advaug.py:111-170 with the call-site constants)
# ---------------------------------------------------------------------------

def draw_gridmask(b: int, h: int, w: int, generator: torch.Generator,
                  device=None, prob: float = 0.7) -> dict:
    """Per sample: apply with probability `prob`, period d ~ U[2, min(h, w)),
    offsets st_h, st_w = randint(0, 2**30) % d."""
    apply = _draw(torch.rand, generator, device, b) < prob
    d = _draw(torch.randint, generator, device, 2, min(h, w), (b,))
    st_h = _draw(torch.randint, generator, device, 0, 2 ** 30, (b,)) % d
    st_w = _draw(torch.randint, generator, device, 0, 2 ** 30, (b,)) % d
    return dict(apply=apply, d=d, st_h=st_h, st_w=st_w)


def apply_gridmask(img: torch.Tensor, apply, d, st_h, st_w,
                   ratio: float = 0.5, mode: int = 1) -> torch.Tensor:
    """GridMask on (B, C, H, W): strips of width l = clip(int(d * ratio +
    0.5), 1, d - 1) every d pixels from the offsets, on the 1.5x canvas
    center-cropped; mode 1 keeps the strips and zeroes the rest."""
    b, c, h, w = img.shape
    d = d.to(torch.int64)
    ll = torch.minimum(torch.floor(d * ratio + 0.5).to(torch.int64).clamp(
        min=1), d - 1)
    hh, ww = int(1.5 * h), int(1.5 * w)
    ys = torch.arange(h, device=img.device) + (hh - h) // 2
    xs = torch.arange(w, device=img.device) + (ww - w) // 2

    def strips(coords, st):
        rel = coords[None, :] - st.to(torch.int64)[:, None]
        return (rel >= 0) & (torch.remainder(rel, d[:, None]) < ll[:, None])

    zeroed = strips(ys, st_h)[:, :, None] | strips(xs, st_w)[:, None, :]
    mask = zeroed if mode == 1 else ~zeroed
    mask = mask | ~apply[:, None, None]
    return img * mask.to(img.dtype)[:, None]


def gridmask(img: torch.Tensor, generator: torch.Generator,
             ratio: float = 0.5, mode: int = 1,
             prob: float = 0.7) -> torch.Tensor:
    b, _, h, w = img.shape
    return apply_gridmask(
        img, **draw_gridmask(b, h, w, generator, img.device, prob),
        ratio=ratio, mode=mode)


# ---------------------------------------------------------------------------
# 3-view synthesis for AdvMix
# ---------------------------------------------------------------------------

def draw_advmix_views(b: int, h: int, w: int,
                      generator: torch.Generator, device=None) -> dict:
    return dict(autoaugment=draw_autoaugment(b, generator, device),
                gridmask=draw_gridmask(b, h, w, generator, device))


def make_advmix_views(clean: torch.Tensor,
                      generator: torch.Generator | None = None,
                      draws: dict | None = None, out_dtype=None,
                      style_mask: torch.Tensor | None = None,
                      compute_dtype=None) -> torch.Tensor:
    """(B, 9, H, W) channel-concat [clean, autoaug, gridmask] views of
    `clean` (B, 3, H, W) float in [0, 255], each normalized like
    torchvision ToTensor + Normalize. The random parameters come from
    `generator`, or from `draws` (as `draw_advmix_views` returns them).

    `style_mask` (B,), 1.0 where a sample is stylized, is the --sp_style
    exemption (`advaug.py:182,192`): such rows skip AutoAugment and
    GridMask, so their three views are all the normalized input.

    `compute_dtype=torch.bfloat16` runs the synthesis in bf16: integers up
    to 255 are exact there, so it loses at most sharpness' fractional
    smoothing while moving half the bytes."""
    if compute_dtype is not None:
        clean = clean.to(compute_dtype)
    b, _, h, w = clean.shape
    if draws is None:
        draws = draw_advmix_views(b, h, w, generator, clean.device)
    aa = apply_autoaugment(clean, **draws["autoaugment"])
    mean = (torch.tensor(IMAGENET_MEAN, dtype=torch.float32,
                         device=clean.device) * 255.0).to(clean.dtype)
    std = (torch.tensor(IMAGENET_STD, dtype=torch.float32,
                        device=clean.device) * 255.0).to(clean.dtype)

    def norm(x):
        return (x - mean[None, :, None, None]) / std[None, :, None, None]

    # GridMask runs on the normalized tensor in the reference
    # (advaug.py:190-202), so masked pixels are exactly 0 there
    clean_n = norm(clean)
    aa_n = norm(aa)
    gm = apply_gridmask(clean_n, **draws["gridmask"])
    if style_mask is not None:
        m = (style_mask > 0.5).view(-1, 1, 1, 1)
        aa_n = torch.where(m, clean_n, aa_n)
        gm = torch.where(m, clean_n, gm)
    views = torch.cat([clean_n, aa_n, gm], dim=1)
    return views if out_dtype is None else views.to(out_dtype)
