"""The 19 image corruptions of Hendrycks & Dietterich's `imagecorruptions`
(15 benchmark types and 4 held out, severities 1-5), a frozen copy for the
reference of the robustness sweep.

Copied from the measured program's `ops/corruptions.py` when the benchmark
was defined: the sweep's exact-render forms (the draws of a render seeded 1,
replayed on the host), float64 sums in the blurs, the DCT and the resizes,
and true divisions. A later change to the program's corruptions is held
against these semantics. Original docstring follows.

Batched on-device image corruptions (COCO-C / MPII-C synthesis).

Port of `advmix_tpu/ops/corruptions.py`: the `imagecorruptions` taxonomy
(Hendrycks & Dietterich), 15 benchmark types + 4 holdout types x 5
severities, each a batched function over NHWC `(B, H, W, 3)` float images
in [0, 255] that returns the same shape, on the input tensor's device.

Two forms per stochastic corruption, as in the JAX package:
- traced (generator-driven): the training-time `--random_corruption` form,
  distribution-level parity with the reference's free-running stream;
- exact_render (the EXACT_RENDER registry): pre-rendered -C dataset
  semantics. The reference seeds np.random.seed(1) before every render, so
  each render's draws are a pure function of (corruption, severity, shape);
  they are replayed on the host with the same MT19937 stream and kept on
  the device as constants (glass_blur's swap permutation, motion_blur's
  angle, snow's layer, elastic_transform's fields, spatter's masks, frost's
  texture crop).

Each random corruption is split in two: `draw_<name>(x, severity,
generator)` takes its random fields from a `torch.Generator` and returns
them as a dict, `<name>(x, severity, **draws)` applies them. The JAX
package's key splits cannot be reproduced by a generator, so the tests
replay its draws into the apply functions.

Host-made constants (blur operators, border indices, resize matrices, disk
kernels, zoom matrices and the seed-1 draws above) are built once per
shape and device and kept in a bounded cache, `release_constants` drops
those of one image shape. Blurs, the DCT and the resizes sum their f32
inputs times f32 weights in f64 and round the sum to f32, so TF32, which
touches f32 convolutions and matmuls only, never applies, whatever the
caller set: reduced precision flips uint8 truncations (glass_blur) and
JPEG quantization bins. With every division by a constant a true
division (`_div`), the card and the CPU, which order a convolution's sum
differently, give the same f32 bits but for a sum within 1e-16 of an f32
rounding boundary. In f32 the two orders put a sum whose exact value is
an integer (defocus_blur's 1/29 disk weights) an ulp either side of it,
and the uint8 truncation of a -C render turns that ulp into a level. Nothing here
imports cv2 or PIL, except spatter's exact water arm (severities 1-3) and
frost's optional texture directory, which need cv2 and say so.
"""

from __future__ import annotations

import collections
import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from .warp import warp_affine

# ---------------------------------------------------------------------------
# host constants, cached per shape and device
# ---------------------------------------------------------------------------

_CONSTANTS: "collections.OrderedDict" = collections.OrderedDict()
MAX_CONSTANTS = 256


def _const(key: tuple, build):
    """The constant of `key`, built by `build()` at its first use. Keys are
    (kind, shape tag, ...): the tag is the (h, w) or (n,) the constant was
    made for. Least recently used entries leave beyond MAX_CONSTANTS."""
    val = _CONSTANTS.pop(key, None)
    if val is None:
        val = build()
    _CONSTANTS[key] = val
    while len(_CONSTANTS) > MAX_CONSTANTS:
        _CONSTANTS.popitem(last=False)
    return val


def release_constants(h: int | None = None, w: int | None = None) -> int:
    """Drop the cached constants made for an (h, w) image (and the 1-D ones
    of length h or w), or all of them with no arguments. Returns how many
    were dropped."""
    if h is None:
        n = len(_CONSTANTS)
        _CONSTANTS.clear()
        return n
    tags = {(h, w), (h,), (w,)}
    keys = [k for k in _CONSTANTS if k[1] in tags]
    for k in keys:
        del _CONSTANTS[k]
    return len(keys)


def _on(arr: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _div(x: torch.Tensor, value: float) -> torch.Tensor:
    """x / value, correctly rounded on every device. (A CUDA kernel divides
    by a host scalar as a multiplication by its reciprocal, an ulp off the
    CPU's division; a 0-dim device tensor gets the true division.)"""
    d = _const(("scalar", (), float(value), str(x.device)),
               lambda: torch.tensor(float(value), dtype=torch.float32,
                                    device=x.device))
    return x / d


def _index(device) -> torch.device:
    """`device` with the current CUDA device's index where it names none."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def device_generator(generator: torch.Generator | None,
               device: torch.device) -> torch.Generator:
    """A generator on `device`: the given one if it lives there, else one
    seeded from a draw of it; None gives a fresh generator seeded 1 (a
    deterministic render, as the reference seeds every render)."""
    device = _index(device)
    if generator is None:
        return torch.Generator(device=device).manual_seed(1)
    if _index(generator.device) == device:
        return generator
    seed = int(torch.randint(0, 2**62, (1,), generator=generator))
    return torch.Generator(device=device).manual_seed(seed)


def _rand(shape, g: torch.Generator) -> torch.Tensor:
    return torch.rand(shape, generator=g, device=g.device)


def _randn(shape, g: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=g, device=g.device)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _gaussian_kernel_1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(x**2) / (2.0 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def _reflect_index(i: torch.Tensor, n: int, include_edge: bool):
    """Boundary index folding for out-of-range indices. include_edge=True
    is scipy's 'reflect' (d c b a | a b c d, period 2n); False is scipy
    'mirror' / cv2 BORDER_REFLECT_101 (d c b | a b c d | c b a, period
    2n-2). Valid for any magnitude of overrun (periodic)."""
    if include_edge:
        period = 2 * n
        i = torch.remainder(i, period)
        return torch.where(i >= n, period - 1 - i, i)
    period = max(2 * n - 2, 1)
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


def _np_border_index(i: np.ndarray, n: int, mode: str) -> np.ndarray:
    """Index folding by scipy border mode name: 'nearest' (edge clamp,
    skimage.filters.gaussian's default), 'symmetric' (scipy 'reflect',
    edge repeated) or 'mirror' (edge not repeated)."""
    if mode == "nearest":
        return np.clip(i, 0, n - 1)
    if mode == "symmetric":
        period = 2 * n
        i = np.mod(i, period)
        return np.where(i >= n, period - 1 - i, i)
    period = max(2 * n - 2, 1)
    i = np.mod(i, period)
    return np.where(i >= n, period - i, i)


def _blur_matrix(n: int, sigma: float, radius: int, mode: str) -> np.ndarray:
    """Exact dense 1-D blur operator with the boundary folded in:
    blurred[i] = sum_t k[t] * x[fold(i + t)] == (x @ W^T)[i]."""
    k = _gaussian_kernel_1d(sigma, radius)
    mat = np.zeros((n, n), np.float32)
    taps = np.arange(-radius, radius + 1)
    for i in range(n):
        np.add.at(mat[i], _np_border_index(i + taps, n, mode), k)
    return mat


def _sep_blur(x: torch.Tensor, sigma: float, truncate: float = 4.0,
              mode: str = "mirror") -> torch.Tensor:
    """Separable Gaussian blur of NHWC f32 `x`. mode 'mirror', 'symmetric'
    or 'nearest' (see `_np_border_index`). Small radii run as taps-wide
    convs over a border-extended copy; where 2 * radius + 1 exceeds
    min(h, w) (elastic_transform's sigma = 0.7 * 244 is a 513-px radius)
    kernel and border fold into an exact dense (n, n) operator per axis,
    two small matmuls. The f32 weights are summed in f64 and the result
    rounded to f32: the same f32 bits on every device (see the module
    docstring)."""
    if sigma <= 0:
        return x
    radius = max(1, int(truncate * sigma + 0.5))
    b, h, w, c = x.shape
    dev = str(x.device)
    x = x.to(torch.float64)
    if 2 * radius + 1 > min(h, w):
        wh, ww = (_const(("blur_matrix", (n,), sigma, radius, mode, dev),
                         lambda n=n: _on(_blur_matrix(n, sigma, radius,
                                                      mode).astype(
                             np.float64), x.device))
                  for n in (h, w))
        xh = torch.einsum("ij,bjwc->biwc", wh, x)
        return torch.einsum("ij,bhjc->bhic", ww, xh).to(torch.float32)
    k = _const(("gaussian_taps", (), sigma, radius, dev),
               lambda: _on(_gaussian_kernel_1d(sigma, radius).astype(
                   np.float64), x.device))
    idx_h, idx_w = (
        _const(("border_index", (n,), radius, mode, dev),
               lambda n=n: _on(_np_border_index(
                   np.arange(-radius, n + radius), n, mode), x.device))
        for n in (h, w))
    xp = x.index_select(1, idx_h).permute(0, 3, 1, 2)
    xh = F.conv2d(xp.reshape(b * c, 1, h + 2 * radius, w),
                  k.view(1, 1, -1, 1))
    xw = F.conv2d(xh.index_select(3, idx_w), k.view(1, 1, 1, -1))
    return xw.reshape(b, c, h, w).permute(0, 2, 3, 1).to(torch.float32)


def _conv2d_same(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Per-channel 2-D convolution of NHWC f32 `x` with reflect padding,
    summed in f64 (`kernel` f64) and rounded to f32."""
    kh, kw = kernel.shape
    ph, pw = kh // 2, kw // 2
    b, h, w, c = x.shape
    xp = x.to(torch.float64).permute(0, 3, 1, 2).reshape(b * c, 1, h, w)
    out = F.conv2d(F.pad(xp, (pw, pw, ph, ph), mode="reflect"),
                   kernel.view(1, 1, kh, kw))
    return out.reshape(b, c, h, w).permute(0, 2, 3, 1).to(torch.float32)


def _clip01(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 1.0)


def _rgb_to_hsv(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB in [0, 1] -> HSV, h in [0, 1)."""
    r, g, b = x.unbind(-1)
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    d = mx - mn
    safe_d = torch.where(d == 0, 1.0, d)
    h = _div(torch.where(
        d == 0, 0.0,
        torch.where(mx == r, torch.remainder((g - b) / safe_d, 6.0),
                    torch.where(mx == g, (b - r) / safe_d + 2.0,
                                (r - g) / safe_d + 4.0))), 6.0)
    s = torch.where(mx == 0, 0.0, d / torch.where(mx == 0, 1.0, mx))
    return torch.stack([h, s, mx], -1)


# which of (v, p, q, t) each of r, g, b takes in each of the 6 hue sectors
_HSV_SECTORS = np.array([[0, 3, 1], [2, 0, 1], [1, 0, 3],
                         [1, 2, 0], [3, 1, 0], [0, 1, 2]], np.int64)


def _hsv_to_rgb(x: torch.Tensor) -> torch.Tensor:
    h, s, v = x.unbind(-1)
    h = h * 6.0
    i = torch.floor(h)
    f = h - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    sector = torch.remainder(i, 6.0).to(torch.int64)
    table = _const(("hsv_sectors", (), str(x.device)),
                   lambda: _on(_HSV_SECTORS, x.device))
    return torch.stack([v, p, q, t], -1).gather(-1, table[sector])


# ---------------------------------------------------------------------------
# noise family
# ---------------------------------------------------------------------------

def draw_gaussian_noise(x, severity, g):
    return dict(n=_randn(x.shape, g))


def gaussian_noise(x, severity, n):
    c = [0.08, 0.12, 0.18, 0.26, 0.38][severity - 1]
    return _clip01(_div(x, 255.0) + n * c) * 255.0


def _shot_rate(severity: int) -> int:
    return [60, 25, 12, 5, 3][severity - 1]


def draw_shot_noise(x, severity, g):
    """Poisson counts of rate x / 255 * c: the draw reads the image."""
    lam = _div(x, 255.0) * _shot_rate(severity)
    return dict(counts=torch.poisson(lam, generator=g))


def shot_noise(x, severity, counts):
    return _clip01(_div(counts, _shot_rate(severity))) * 255.0


def draw_impulse_noise(x, severity, g):
    return dict(u=_rand(x.shape[:3], g), salt=_rand(x.shape[:3], g) < 0.5)


def impulse_noise(x, severity, u, salt):
    """Salt & pepper, amount c (skimage random_noise 's&p', salt_vs_pepper
    0.5), one draw per pixel shared by its channels."""
    c = [0.03, 0.06, 0.09, 0.17, 0.27][severity - 1]
    corrupted = u < c
    out = torch.where((corrupted & salt)[..., None], 255.0, x)
    return torch.where((corrupted & ~salt)[..., None], 0.0, out)


def draw_speckle_noise(x, severity, g):
    return dict(n=_randn(x.shape, g))


def speckle_noise(x, severity, n):
    c = [0.15, 0.2, 0.35, 0.45, 0.6][severity - 1]
    x01 = _div(x, 255.0)
    return _clip01(x01 + x01 * (n * c)) * 255.0


# ---------------------------------------------------------------------------
# blur family
# ---------------------------------------------------------------------------

def gaussian_blur(x, severity):
    # skimage.filters.gaussian's default border mode is 'nearest'
    c = [1, 2, 3, 4, 6][severity - 1]
    return _clip01(_sep_blur(_div(x, 255.0), c, mode="nearest")) * 255.0


def _cv2_gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel(ksize, sigma > 0) for a CV_32F image:
    exp(-(i - (ksize-1)/2)^2 / (2 sigma^2)) normalized, in double, then f32."""
    i = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(i * i) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _disk_kernel(radius: int, alias_blur: float) -> np.ndarray:
    """imagecorruptions' `disk()`: an aliased disk, normalized, then
    cv2.GaussianBlur(ksize 3 or 5, sigma alias_blur) with cv2's default
    border (BORDER_REFLECT_101), computed here in numpy: the separable
    Gaussian in f32, rows then columns. Kept verbatim is the quirk that
    the result is NOT renormalized (the border reflection makes it sum to
    ~1.01 at radius >= 8, brightening the output slightly)."""
    if radius <= 8:
        coords = np.arange(-8, 8 + 1)
        ksize = 3
    else:
        coords = np.arange(-radius, radius + 1)
        ksize = 5
    xg, yg = np.meshgrid(coords, coords)
    aliased = np.array((xg**2 + yg**2) <= radius**2, dtype=np.float32)
    aliased /= aliased.sum()
    k = _cv2_gaussian_kernel(ksize, alias_blur)
    n = aliased.shape[0]
    idx = _np_border_index(np.arange(-(ksize // 2), n + ksize // 2), n,
                           "mirror")
    rows = aliased[:, idx]
    rows = sum(k[t] * rows[:, t:t + n] for t in range(ksize))
    cols = rows[idx, :]
    return sum(k[t] * cols[t:t + n, :] for t in range(ksize)).astype(
        np.float32)


_DEFOCUS = [(3, 0.1), (4, 0.5), (6, 0.5), (8, 0.5), (10, 0.5)]


def defocus_blur(x, severity):
    radius, alias = _DEFOCUS[severity - 1]
    k = _const(("disk", (), radius, alias, str(x.device)),
               lambda: _on(_disk_kernel(radius, alias).astype(np.float64),
                           x.device))
    return _clip01(_conv2d_same(_div(x, 255.0), k)) * 255.0


def _streak_offsets(radius: int, sigma: float, angle_deg: float,
                    h: int, w: int):
    """Offsets + weights of imagecorruptions' `_motion_blur` shift loop,
    verbatim: width = 2*radius+1 steps; step i shifts by
    (-ceil(i*sin(a) - 0.5), -ceil(i*cos(a) - 0.5)) with weight
    kern1d[i] from a CENTERED normalized gaussian of std sigma; the loop
    breaks when the simulated motion exceeds the image borders (and does
    NOT renormalize the lost mass). The streak is one-sided from the
    origin, so the blur displaces content toward the motion direction."""
    width = 2 * radius + 1
    n = np.arange(width, dtype=np.float64)
    k1d = np.exp(-0.5 * ((n - (width - 1) / 2.0) / sigma) ** 2)
    k1d = k1d / k1d.sum()
    rad = math.radians(angle_deg)
    offsets = []
    for i in range(width):
        dy = -int(math.ceil(i * math.sin(rad) - 0.5))
        dx = -int(math.ceil(i * math.cos(rad) - 0.5))
        if abs(dy) >= h or abs(dx) >= w:
            break
        offsets.append((dy, dx, float(k1d[i])))
    return offsets


def _streak_table(radius: int, sigma: float, angles, h: int, w: int):
    """(A, K) step offsets dy, dx and weights for an angle bank; steps past
    an angle's border break carry weight 0."""
    offs = [_streak_offsets(radius, sigma, a, h, w) for a in angles]
    k = max(len(o) for o in offs)
    table = np.zeros((3, len(angles), k), np.float64)
    for a, o in enumerate(offs):
        if o:
            table[:, a, :len(o)] = np.asarray(o, np.float64).T
    return table


def _streak_blur_per_image(x: torch.Tensor, radius: int, sigma: float,
                           angles, sel: torch.Tensor) -> torch.Tensor:
    """Shift-accumulate motion streak (edge-clamped shifts, NHWC) with
    image i at angles[sel[i]]: each step gathers every image at its own
    offset and adds it times its weight. The same sums as blurring the
    batch at every angle of the bank and picking one per image, at one
    angle's cost."""
    b, h, w, c = x.shape
    dev = x.device
    def build():
        dy, dx, wgt = _streak_table(radius, sigma, angles, h, w)
        return (_on(dy.astype(np.int64), dev), _on(dx.astype(np.int64), dev),
                _on(wgt.astype(np.float32), dev))

    dy, dx, wgt = _const(("streak_table", (h, w), radius, sigma,
                          tuple(angles), str(dev)), build)
    ys = torch.arange(h, device=dev)
    xs = torch.arange(w, device=dev)
    flat = x.reshape(b, h * w, c)
    acc = torch.zeros_like(x)
    dy, dx, wgt = dy[sel], dx[sel], wgt[sel]  # (B, K)
    for k in range(dy.shape[1]):
        yy = (ys[None, :] - dy[:, k, None]).clamp(0, h - 1)
        xx = (xs[None, :] - dx[:, k, None]).clamp(0, w - 1)
        idx = (yy[:, :, None] * w + xx[:, None, :]).view(b, h * w, 1)
        shifted = flat.gather(1, idx.expand(b, h * w, c)).view(b, h, w, c)
        acc = acc + wgt[:, k].view(b, 1, 1, 1) * shifted
    return acc


_MOTION = [(10, 3), (15, 5), (15, 8), (15, 12), (20, 15)]
MOTION_ANGLES = tuple(np.linspace(-45.0, 45.0, 16).tolist())


def draw_motion_blur(x, severity, g):
    """The angle-bank index per image (16 angles over [-45, 45])."""
    idx = torch.randint(0, len(MOTION_ANGLES), (x.shape[0],), generator=g,
                        device=g.device)
    return dict(angle_idx=idx)


def motion_blur(x, severity, angle_idx):
    """Motion blur: the original draws angle ~ U(-45, 45) per image and
    runs the one-sided shift loop; the angle draw is discretized into a
    16-angle bank and each image blurred at its own."""
    radius, sigma = _MOTION[severity - 1]
    out = _streak_blur_per_image(_div(x, 255.0), radius, sigma, MOTION_ANGLES,
                                 angle_idx)
    return _clip01(out) * 255.0


def motion_blur_exact(x, severity):
    """The pre-rendered -C bits: the angle is the first uniform(-45, 45)
    of the seed-1 stream, the same for every image."""
    radius, sigma = _MOTION[severity - 1]
    angle = float(np.random.RandomState(1).uniform(-45.0, 45.0))
    sel = torch.zeros(x.shape[0], dtype=torch.long, device=x.device)
    out = _streak_blur_per_image(_div(x, 255.0), radius, sigma, (angle,), sel)
    return _clip01(out) * 255.0


def _clipped_zoom_matrix(h: int, w: int, zf: float) -> np.ndarray:
    """Forward (src->dst) affine reproducing imagecorruptions'
    `clipped_zoom`: center-crop ceil(dim/zf), scipy.ndimage.zoom order=1
    (endpoint-aligned mapping in = out*(in-1)/(out-1)), then top-left
    truncation to (h, w). All sample coords stay interior, so bilinear
    warp == the scipy chain exactly."""
    ch0 = int(np.ceil(h / float(zf)))
    top0 = (h - ch0) // 2
    ch1 = int(np.ceil(w / float(zf)))
    top1 = (w - ch1) // 2
    oh = int(round(ch0 * zf))
    ow = int(round(ch1 * zf))
    sy = (ch0 - 1) / (oh - 1) if oh > 1 else 0.0
    sx = (ch1 - 1) / (ow - 1) if ow > 1 else 0.0
    # dst->src: src = top + dst*s ; warp_affine wants forward src->dst
    fy = 1.0 / sy if sy else 1.0
    fx = 1.0 / sx if sx else 1.0
    return np.array(
        [[fx, 0, -top1 * fx], [0, fy, -top0 * fy]], np.float32
    )


_ZOOM_FACTORS = [
    np.arange(1, 1.11, 0.01),
    np.arange(1, 1.16, 0.01),
    np.arange(1, 1.21, 0.02),
    np.arange(1, 1.26, 0.02),
    np.arange(1, 1.31, 0.03),
]


def _zoom_mats(h: int, w: int, factors, device) -> torch.Tensor:
    """(F, 1, 2, 3) forward matrices of `_clipped_zoom_matrix`."""
    key = ("zoom_matrices", (h, w), tuple(float(f) for f in factors),
           str(device))
    return _const(key, lambda: _on(np.stack(
        [_clipped_zoom_matrix(h, w, float(f)) for f in factors])[:, None],
        device))


def zoom_blur(x, severity):
    factors = _ZOOM_FACTORS[severity - 1]
    b, h, w, _ = x.shape
    x01 = _div(x, 255.0)
    acc = torch.zeros_like(x01)
    for m in _zoom_mats(h, w, factors, x.device):
        acc = acc + warp_affine(x01, m.expand(b, 2, 3), (w, h))
    out = _div(x01 + acc, len(factors) + 1)
    return _clip01(out) * 255.0


# (sigma, max_delta, iterations) — imagecorruptions glass_blur severities
GLASS_CONSTANTS = [
    (0.7, 1, 2), (0.9, 2, 1), (1.0, 2, 3), (1.1, 3, 2), (1.5, 4, 2)
]


def glass_blur_permutation(h: int, w: int, severity: int,
                           rng=None) -> np.ndarray:
    """Compose the original's sequential interior pixel swaps into one
    gather. glass_blur walks the interior in descending order swapping
    each pixel with a random neighbour; the swaps are image-independent
    transpositions, so the whole cascade is one permutation of pixel
    indices determined by (h, w, the RNG stream) alone, composed on the
    host (`_glass_compose`, a Python loop).

    rng defaults to np.random.RandomState(1), the reference's seed before
    every render. Returns int32 (h*w,) source indices
    (out.flat[i] = img.flat[perm[i]] per channel)."""
    _, max_delta, iters = GLASS_CONSTANTS[severity - 1]
    if rng is None:
        rng = np.random.RandomState(1)
    n_h = len(range(h - max_delta, max_delta, -1))
    n_w = len(range(w - max_delta, max_delta, -1))
    # one bulk randint consumes the MT19937 stream exactly like the
    # original's per-swap `randint(-d, d, size=(2,))` calls
    deltas = rng.randint(
        -max_delta, max_delta, size=(iters * n_h * n_w, 2)
    ).astype(np.int32)
    return _glass_compose(h, w, max_delta, iters, deltas)


def _glass_compose(h, w, max_delta, iters, deltas) -> np.ndarray:
    """The swaps composed in order into one source-index permutation."""
    src = np.arange(h * w, dtype=np.int32)
    t = 0
    for _ in range(iters):
        for hh in range(h - max_delta, max_delta, -1):
            base = hh * w
            for ww in range(w - max_delta, max_delta, -1):
                dx, dy = deltas[t]
                t += 1
                p = base + ww
                q = (hh + dy) * w + (ww + dx)
                src[p], src[q] = src[q], src[p]
    return src


def _glass_apply(x, severity, perm):
    """imagecorruptions glass_blur given the composed swap permutation:
    skimage-gaussian blur (mode='nearest') -> np.uint8 truncation ->
    permutation gather -> blur -> clip, in f32."""
    sigma, _, _ = GLASS_CONSTANTS[severity - 1]
    b, h, w, c = x.shape
    out = _sep_blur(_div(x, 255.0), sigma, mode="nearest")
    # np.uint8(v * 255) truncates toward zero
    out = torch.floor(torch.clamp(out * 255.0, 0.0, 255.0))
    out = out.reshape(b, h * w, c).index_select(1, perm)
    out = _sep_blur(_div(out.reshape(b, h, w, c), 255.0), sigma, mode="nearest")
    return _clip01(out) * 255.0


def glass_blur_exact(x, severity):
    """The pre-rendered -C bits (seed-1 swap permutation)."""
    _, h, w, _ = x.shape
    perm = _const(("glass_permutation", (h, w), severity, str(x.device)),
                  lambda: _on(glass_blur_permutation(h, w, severity)
                              .astype(np.int64), x.device))
    return _glass_apply(x, severity, perm)


def draw_glass_blur(x, severity, g):
    """One (B, H, W, 2) displacement field in [-max_delta, max_delta) per
    iteration (randint's upper bound is exclusive, as the original's)."""
    _, max_delta, iters = GLASS_CONSTANTS[severity - 1]
    b, h, w, _ = x.shape
    return dict(deltas=[torch.randint(-max_delta, max_delta, (b, h, w, 2),
                                      generator=g, device=g.device)
                        for _ in range(iters)])


def glass_blur(x, severity, deltas):
    """The generator-driven form: the same number of random local
    displacements over the same interior region, each iteration one
    parallel gather (a parallel gather can duplicate pixels where the
    serial swaps conserve them: the one sanctioned deviation)."""
    sigma, max_delta, _ = GLASS_CONSTANTS[severity - 1]
    b, h, w, c = x.shape
    out = _sep_blur(_div(x, 255.0), sigma, mode="nearest")
    out = torch.floor(torch.clamp(out * 255.0, 0.0, 255.0))
    ar_h = torch.arange(h, device=x.device)
    ar_w = torch.arange(w, device=x.device)
    interior = (((ar_h > max_delta) & (ar_h < h - max_delta + 1))[:, None]
                & ((ar_w > max_delta) & (ar_w < w - max_delta + 1))[None, :])
    for d in deltas:
        d = torch.where(interior[None, :, :, None], d, 0)
        ys = (ar_h[None, :, None] + d[..., 0]).clamp(0, h - 1)
        xs = (ar_w[None, None, :] + d[..., 1]).clamp(0, w - 1)
        idx = (ys * w + xs).reshape(b, h * w, 1).expand(b, h * w, c)
        out = out.reshape(b, h * w, c).gather(1, idx).view(b, h, w, c)
    return _clip01(_sep_blur(_div(out, 255.0), sigma, mode="nearest")) * 255.0


# ---------------------------------------------------------------------------
# weather family
# ---------------------------------------------------------------------------

def plasma_noise_shapes(mapsize: int):
    """Per-level noise shapes consumed by `_plasma_core` (square step,
    then the two diamond fills), outermost level first."""
    shapes = []
    stepsize = mapsize
    while stepsize >= 2:
        n = mapsize // stepsize
        shapes.append(((n, n), (n, n), (n, n)))
        stepsize //= 2
    return shapes


def _plasma_core(noises, mapsize: int) -> torch.Tensor:
    """Diamond-square plasma fractal in [0, 1], (B, mapsize, mapsize), for
    a whole batch at once, mirroring imagecorruptions' mapgen-derived
    `plasma_fractal` roll conventions exactly (fillsquares: +1 rolls on
    the corner grid; filldiamonds: drgrid +1 / ulgrid -1 rolls, including
    its wraparound quirk). `noises[level]` holds the pre-scaled (B, n, n)
    wibble draws of that level in `plasma_noise_shapes` order."""
    sq0 = noises[0][0]
    arr = torch.zeros((sq0.shape[0], mapsize, mapsize), dtype=torch.float32,
                      device=sq0.device)
    stepsize = mapsize
    level = 0
    while stepsize >= 2:
        half = stepsize // 2
        sq_n, ldr_n, tdr_n = noises[level]
        # fillsquares
        cornerref = arr[:, ::stepsize, ::stepsize]
        squareaccum = cornerref + torch.roll(cornerref, 1, dims=1)
        squareaccum = squareaccum + torch.roll(squareaccum, 1, dims=2)
        arr[:, half::stepsize, half::stepsize] = squareaccum / 4.0 + sq_n
        # filldiamonds (the grids it reads are not the ones it writes)
        drgrid = arr[:, half::stepsize, half::stepsize].clone()
        ulgrid = arr[:, ::stepsize, ::stepsize].clone()
        ldrsum = drgrid + torch.roll(drgrid, 1, dims=1)
        lulsum = ulgrid + torch.roll(ulgrid, -1, dims=2)
        arr[:, 0::stepsize, half::stepsize] = (ldrsum + lulsum) / 4.0 + ldr_n
        tdrsum = drgrid + torch.roll(drgrid, 1, dims=2)
        tulsum = ulgrid + torch.roll(ulgrid, -1, dims=1)
        arr[:, half::stepsize, 0::stepsize] = (tdrsum + tulsum) / 4.0 + tdr_n
        stepsize //= 2
        level += 1
    arr = arr - arr.amin(dim=(1, 2), keepdim=True)
    return arr / (arr.amax(dim=(1, 2), keepdim=True) + 1e-8)


def _draw_plasma(b: int, mapsize: int, wibbledecay: float, g):
    """Per-level wibble noises uniform(-wibble, wibble), wibble from 100
    divided by `wibbledecay` per level, for B images."""
    noises = []
    wibble = 100.0
    for shapes in plasma_noise_shapes(mapsize):
        noises.append(tuple((_rand((b,) + s, g) * 2.0 - 1.0) * wibble
                            for s in shapes))
        wibble /= wibbledecay
    return noises


def _next_pow2(n):
    return 1 << (n - 1).bit_length()


_FOG = [(1.5, 2), (2.0, 2), (2.5, 1.7), (2.5, 1.5), (3.0, 1.4)]


def draw_fog(x, severity, g):
    b, h, w, _ = x.shape
    return dict(noises=_draw_plasma(b, _next_pow2(max(h, w)),
                                    _FOG[severity - 1][1], g))


def fog(x, severity, noises):
    c, _ = _FOG[severity - 1]
    _, h, w, _ = x.shape
    plasma = _plasma_core(noises, _next_pow2(max(h, w)))[:, :h, :w]
    x01 = _div(x, 255.0)
    mx = x01.amax(dim=(1, 2, 3), keepdim=True)
    out = x01 + c * plasma[..., None]
    return _clip01(out * mx / (mx + c)) * 255.0


_FROST_DIR = None  # explicit override; falls back to $ADVMIX_FROST_DIR
_FROST_BANK_CACHE: dict = {}
_FROST = [(1, 0.4), (0.8, 0.6), (0.7, 0.7), (0.65, 0.7), (0.6, 0.75)]


def set_frost_texture_dir(path):
    """Point frost() at a directory of texture photographs (e.g.
    imagecorruptions' frost_imgs/). None reverts to $ADVMIX_FROST_DIR or,
    absent that, the procedural texture."""
    global _FROST_DIR
    _FROST_DIR = path
    _FROST_BANK_CACHE.clear()


def _frost_bank(h: int, w: int):
    """Load and pre-scale the frost textures for an (h, w) target as the
    published frost() does (INTER_CUBIC by scaling_factor * 1.1, where
    scaling_factor makes the texture cover the target), stacked zero-padded
    into one uint8 bank. Returns (bank (N, Hc, Wc, 3) uint8, heights,
    widths) or None without a texture directory. Reads with cv2."""
    d = _FROST_DIR if _FROST_DIR is not None else os.environ.get(
        "ADVMIX_FROST_DIR")
    if not d:
        return None
    ck = (d, h, w)
    if ck in _FROST_BANK_CACHE:
        return _FROST_BANK_CACHE[ck]
    import glob

    import cv2

    texs = []
    for p in sorted(glob.glob(os.path.join(d, "*"))):
        if not p.lower().endswith((".png", ".jpg", ".jpeg", ".bmp")):
            continue
        img = cv2.imread(p)  # BGR, as the original reads them
        if img is None:
            continue
        fh, fw = img.shape[:2]
        sf = 1.0
        if fh < h and fw >= w:
            sf = h / fh
        elif fh >= h and fw < w:
            sf = w / fw
        elif fh < h and fw < w:
            sf = max(h / fh, w / fw)
        sf *= 1.1  # the original always over-scales by 1.1
        new_wh = (int(np.ceil(fw * sf)), int(np.ceil(fh * sf)))
        img = cv2.resize(img, dsize=new_wh, interpolation=cv2.INTER_CUBIC)
        texs.append(img[..., ::-1])  # BGR->RGB ([2,1,0] in the original)
    if not texs:
        _FROST_BANK_CACHE[ck] = None
        return None
    hs = np.asarray([t.shape[0] for t in texs], np.int32)
    ws = np.asarray([t.shape[1] for t in texs], np.int32)
    bank = np.zeros((len(texs), hs.max(), ws.max(), 3), np.uint8)
    for i, t in enumerate(texs):
        bank[i, : t.shape[0], : t.shape[1]] = t
    out = (bank, hs, ws)
    _FROST_BANK_CACHE[ck] = out
    return out


def _frost_crop_exact(h: int, w: int):
    """The reference render's frost crop on the seed-1 stream: texture
    index np.random.randint(5) (the original indexes its six-file list
    with randint(5), so the last texture is never drawn), then row offset
    randint(0, th - h), then col randint(0, tw - w)."""
    bank = _frost_bank(h, w)
    if bank is None:
        return None
    tex_np, hs, ws = bank
    rng = np.random.RandomState(1)
    idx = int(rng.randint(min(5, len(hs))))
    th, tw = int(hs[idx]), int(ws[idx])
    y0 = int(rng.randint(0, max(th - h, 1)))
    x0 = int(rng.randint(0, max(tw - w, 1)))
    return tex_np[idx, y0:y0 + h, x0:x0 + w].astype(np.float32)


def draw_frost(x, severity, g):
    """With a texture bank: a texture index and crop position per image;
    without one: the plasma draws of the procedural texture."""
    b, h, w, _ = x.shape
    if _frost_bank(h, w) is not None:
        n_tex = _frost_bank(h, w)[0].shape[0]
        return dict(tex_idx=torch.randint(0, n_tex, (b,), generator=g,
                                          device=g.device),
                    u_y=_rand((b,), g), u_x=_rand((b,), g))
    return dict(noises=_draw_plasma(b, _next_pow2(max(h, w)), 1.8, g))


def frost(x, severity, noises=None, tex_idx=None, u_y=None, u_x=None):
    """Frost overlay x*a + frost*b. With a texture directory configured
    (set_frost_texture_dir / $ADVMIX_FROST_DIR) the published algorithm:
    per image a texture and a random crop of its cover-resized canvas.
    Without one, a procedural plasma texture sharpened into crystalline
    streaks stands in for the bundled photographs."""
    a, bb = _FROST[severity - 1]
    b, h, w, _ = x.shape
    if tex_idx is not None:
        tex_np, hs, ws = _frost_bank(h, w)
        bank = _const(("frost_bank", (h, w), str(x.device)),
                      lambda: (_on(tex_np, x.device),
                               _on(hs.astype(np.float32), x.device),
                               _on(ws.astype(np.float32), x.device)))
        tex_c, hs_t, ws_t = bank
        ys = torch.floor(u_y * torch.clamp(hs_t[tex_idx] - h, min=1.0))
        xs = torch.floor(u_x * torch.clamp(ws_t[tex_idx] - w, min=1.0))
        rows = ys.long()[:, None] + torch.arange(h, device=x.device)
        cols = xs.long()[:, None] + torch.arange(w, device=x.device)
        tex = tex_c[tex_idx[:, None, None], rows[:, :, None],
                    cols[:, None, :]].to(x.dtype)
        return torch.clamp(x * a + tex * bb, 0, 255)
    base = _plasma_core(noises, _next_pow2(max(h, w)))[:, :h, :w]
    # crystalline look: ridged multifractal + directional streaks
    ridged = 1.0 - torch.abs(base * 2.0 - 1.0)
    streak = _sep_blur(ridged[..., None], 1.0)[..., 0]
    tex = torch.clamp(streak * 1.4 - 0.4, 0.0, 1.0) * 255.0
    return torch.clamp(x * a + tex[..., None] * bb, 0, 255)


def frost_exact(x, severity, g):
    """Seed-1 texture crop with a texture bank; the procedural texture
    from `g` without one (its bit-exact form needs the photographs)."""
    a, bb = _FROST[severity - 1]
    _, h, w, _ = x.shape
    if _frost_bank(h, w) is not None:
        tex = _const(("frost_crop", (h, w), str(x.device)),
                     lambda: _on(_frost_crop_exact(h, w), x.device))
        return torch.clamp(x * a + tex[None] * bb, 0, 255)
    return frost(x, severity, **draw_frost(x, severity, g))


# (loc, scale, zoom, threshold, blur radius, blur sigma, blend)
SNOW_CONSTANTS = [
    (0.1, 0.3, 3.0, 0.5, 10, 4, 0.8),
    (0.2, 0.3, 2.0, 0.5, 12, 4, 0.7),
    (0.55, 0.3, 4.0, 0.9, 12, 8, 0.7),
    (0.55, 0.3, 4.5, 0.85, 12, 8, 0.65),
    (0.55, 0.3, 2.5, 0.85, 12, 12, 0.55),
]
SNOW_ANGLES = tuple(np.linspace(-135.0, -45.0, 8).tolist())


def _snow_composite(x01, layer, blend):
    """Darken toward a brightened luma (cv2 RGB2GRAY weights), then add the
    snow layer AND its 180-degree rotation (np.rot90(snow_layer, k=2))."""
    gray = (0.299 * x01[..., 0:1] + 0.587 * x01[..., 1:2]
            + 0.114 * x01[..., 2:3])
    darkened = torch.maximum(x01, gray * 1.5 + 0.5)
    out = blend * x01 + (1 - blend) * darkened
    return _clip01(out + layer + layer.flip(1, 2)) * 255.0


def _snow_layer_exact(h: int, w: int, severity: int) -> np.ndarray:
    """The reference render's snow layer, host-side float64 on the seed-1
    np.random stream: normal flake field -> clipped_zoom (scipy, order=1)
    -> threshold -> clip[0,1] -> one-sided-shift motion blur at the
    stream's uniform(-135,-45) angle -> round-to-uint8 -> /255.
    Image-independent: one layer serves every image of the shape."""
    from scipy.ndimage import zoom as scizoom

    loc, scale, zoomf, thresh, blen, bsig, _ = SNOW_CONSTANTS[severity - 1]
    rng = np.random.RandomState(1)
    field = rng.normal(size=(h, w), loc=loc, scale=scale)
    angle = float(rng.uniform(-135.0, -45.0))
    ch0 = int(np.ceil(h / float(zoomf)))
    top0 = (h - ch0) // 2
    ch1 = int(np.ceil(w / float(zoomf)))
    top1 = (w - ch1) // 2
    layer = scizoom(field[top0:top0 + ch0, top1:top1 + ch1],
                    (zoomf, zoomf), order=1)[:h, :w]
    layer[layer < thresh] = 0.0
    layer = np.clip(layer, 0.0, 1.0)
    acc = np.zeros_like(layer)
    ys = np.arange(h)
    xs = np.arange(w)
    for dy, dx, wgt in _streak_offsets(blen, bsig, angle, h, w):
        acc += wgt * layer[np.clip(ys - dy, 0, h - 1)][
            :, np.clip(xs - dx, 0, w - 1)]
    layer8 = np.round(acc * 255.0).astype(np.uint8)
    return (layer8.astype(np.float32) / 255.0)[..., None]


def snow_exact(x, severity):
    _, h, w, _ = x.shape
    layer = _const(("snow_layer", (h, w), severity, str(x.device)),
                   lambda: _on(_snow_layer_exact(h, w, severity), x.device))
    return _snow_composite(_div(x, 255.0), layer[None], SNOW_CONSTANTS[
        severity - 1][6])


def draw_snow(x, severity, g):
    """A standard-normal flake field per image and an index into the
    8-angle bank over [-135, -45]."""
    b, h, w, _ = x.shape
    return dict(field=_randn((b, h, w, 1), g),
                angle_idx=torch.randint(0, len(SNOW_ANGLES), (b,),
                                        generator=g, device=g.device))


def snow(x, severity, field, angle_idx):
    loc, scale, zoom, thresh, blur_len, blur_sig, blend = SNOW_CONSTANTS[
        severity - 1]
    b, h, w, _ = x.shape
    layer = field * scale + loc
    # zoom the snow layer with clipped_zoom semantics (crop->scizoom->trim)
    m = _zoom_mats(h, w, [zoom], x.device)[0]
    layer = warp_affine(layer, m.expand(b, 2, 3), (w, h))
    layer = torch.where(layer < thresh, 0.0, layer)
    # the original clips the thresholded layer to [0,1] before the blur
    layer = torch.clamp(layer, 0.0, 1.0)
    layer = _streak_blur_per_image(layer, blur_len, blur_sig, SNOW_ANGLES,
                                   angle_idx)
    # the original rounds the blurred layer to uint8 range
    layer = _div(torch.round(layer * 255.0), 255.0)
    return _snow_composite(_div(x, 255.0), layer, blend)


# (loc, scale, blur sigma, threshold, intensity, mud-flag)
SPATTER_CONSTANTS = [
    (0.65, 0.3, 4, 0.69, 0.6, 0),
    (0.65, 0.3, 3, 0.68, 0.6, 0),
    (0.65, 0.3, 2, 0.68, 0.5, 0),
    (0.65, 0.3, 1, 0.65, 1.5, 1),
    (0.67, 0.4, 1, 0.65, 1.5, 1),
]


def _spatter_mud_mask_exact(h: int, w: int, severity: int) -> np.ndarray:
    """The mud arm's mask, host-side float64 on the seed-1 stream:
    normal liquid field -> skimage-gaussian('nearest') -> >thresh ->
    re-gaussian -> 0.8 cut. Image-independent."""
    from scipy.ndimage import gaussian_filter

    loc, scale, sigma, thresh, _, is_mud = SPATTER_CONSTANTS[severity - 1]
    if not is_mud:
        raise ValueError(f"spatter severity {severity} is the water arm")
    rng = np.random.RandomState(1)
    liquid = rng.normal(size=(h, w), loc=loc, scale=scale)
    liquid = gaussian_filter(liquid, sigma, mode="nearest", truncate=4.0)
    m = (liquid > thresh).astype(np.float64)
    m = gaussian_filter(m, sigma, mode="nearest", truncate=4.0)
    m[m < 0.8] = 0.0
    return m.astype(np.float32)


def _spatter_water_mask_exact(h: int, w: int, severity: int) -> np.ndarray:
    """The water arm's droplet mask, host-side on the seed-1 stream, running
    the published cv2 chain verbatim (image-independent): liquid field ->
    skimage-gaussian('nearest') -> threshold -> *255 uint8 (with the
    original's overflow wrap) -> 255-Canny -> L2 distanceTransform -> TRUNC
    threshold at 20 -> 3x3 blur -> equalizeHist -> emboss filter2D -> 3x3
    blur -> m = uint8_field * dist, normalized to max, * intensity."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "spatter severities 1-3 (the water arm) in their exact form "
            "need cv2 (OpenCV) for the published Canny / distanceTransform "
            "/ equalizeHist chain; it is not installed") from e
    from scipy.ndimage import gaussian_filter

    loc, scale, sigma, thresh, inten, is_mud = SPATTER_CONSTANTS[severity - 1]
    if is_mud:
        raise ValueError(f"spatter severity {severity} is the mud arm")
    rng = np.random.RandomState(1)
    liquid = rng.normal(size=(h, w), loc=loc, scale=scale)
    liquid = gaussian_filter(liquid, sigma, mode="nearest", truncate=4.0)
    liquid[liquid < thresh] = 0.0
    liq_u8 = (liquid * 255).astype(np.uint8)
    dist = 255 - cv2.Canny(liq_u8, 50, 150)
    dist = cv2.distanceTransform(dist, cv2.DIST_L2, 5)
    _, dist = cv2.threshold(dist, 20, 20, cv2.THRESH_TRUNC)
    dist = cv2.blur(dist, (3, 3)).astype(np.uint8)
    dist = cv2.equalizeHist(dist)
    ker = np.array([[-2, -1, 0], [-1, 1, 1], [0, 1, 2]])
    dist = cv2.filter2D(dist, cv2.CV_8U, ker)
    dist = cv2.blur(dist, (3, 3)).astype(np.float32)
    m = liq_u8.astype(np.float32) * dist
    m /= max(float(m.max()), 1e-8)
    return (m * inten).astype(np.float32)


_MUD = (63 / 255.0, 42 / 255.0, 20 / 255.0)  # mud brown, array order
_WATER = (175 / 255.0, 238 / 255.0, 238 / 255.0)  # pale turquoise, RGB


def _mud(x01, m):
    color = torch.cat([m * _MUD[0], m * _MUD[1], m * _MUD[2]], dim=-1)
    return _clip01(x01 * (1 - m) + color) * 255.0


def _water(x01, m):
    color = torch.tensor(_WATER, dtype=torch.float32, device=x01.device)
    return _clip01(x01 + m * color) * 255.0


def spatter_exact(x, severity):
    """Both arms exact: the masks are image-independent, so the seed-1 host
    field (mud) and the published cv2 chain (water) run on the host and
    stay on the device as constants."""
    _, h, w, _ = x.shape
    is_mud = SPATTER_CONSTANTS[severity - 1][5]
    build = _spatter_mud_mask_exact if is_mud else _spatter_water_mask_exact
    m = _const(("spatter_mask", (h, w), severity, str(x.device)),
               lambda: _on(build(h, w, severity), x.device))[None, :, :, None]
    return (_mud if is_mud else _water)(_div(x, 255.0), m)


def draw_spatter(x, severity, g):
    b, h, w, _ = x.shape
    return dict(field=_randn((b, h, w, 1), g))


def spatter(x, severity, field):
    """Spatter (holdout corruption), generator-driven form: severities 1-3
    are the water arm, 4-5 the mud arm. The mud arm is the published
    formula (threshold -> re-blur -> 0.8 cut -> mud-brown replace); the
    water arm keeps its published skeleton (blurred liquid field,
    threshold, droplet-edge emphasis, pale-turquoise additive colour scaled
    by the intensity) with a gradient-magnitude edge term standing in for
    the cv2 chain: distribution-level parity only."""
    loc, scale, sigma, thresh, inten, is_mud = SPATTER_CONSTANTS[severity - 1]
    x01 = _div(x, 255.0)
    liquid = _sep_blur(field * scale + loc, sigma, mode="nearest")
    if is_mud:
        m = (liquid > thresh).to(torch.float32)
        m = _sep_blur(m, sigma, mode="nearest")
        return _mud(x01, torch.where(m < 0.8, 0.0, m))
    wet = torch.where(liquid < thresh, 0.0, liquid)
    # droplet-edge emphasis: normalized gradient magnitude of the wet field
    gy = torch.abs(torch.diff(wet, dim=1, prepend=wet[:, :1]))
    gx = torch.abs(torch.diff(wet, dim=2, prepend=wet[:, :, :1]))
    edge = _sep_blur(gy + gx, 1.0)
    edge = edge / (edge.amax(dim=(1, 2, 3), keepdim=True) + 1e-8)
    m = wet * edge
    m = m / (m.amax(dim=(1, 2, 3), keepdim=True) + 1e-8)
    return _water(x01, m * inten)


# ---------------------------------------------------------------------------
# digital family
# ---------------------------------------------------------------------------

def brightness(x, severity):
    c = [0.1, 0.2, 0.3, 0.4, 0.5][severity - 1]
    hsv = _rgb_to_hsv(_div(x, 255.0))
    hsv = torch.cat([hsv[..., :2], torch.clamp(hsv[..., 2:] + c, 0, 1)], -1)
    return _clip01(_hsv_to_rgb(hsv)) * 255.0


def contrast(x, severity):
    c = [0.4, 0.3, 0.2, 0.1, 0.05][severity - 1]
    x01 = _div(x, 255.0)
    # imagecorruptions pulls toward the per-channel mean
    mean = x01.mean(dim=(1, 2), keepdim=True)
    return _clip01((x01 - mean) * c + mean) * 255.0


def saturate(x, severity):
    c, shift = [(0.3, 0), (0.1, 0), (2, 0), (5, 0.1), (20, 0.2)][severity - 1]
    hsv = _rgb_to_hsv(_div(x, 255.0))
    hsv = torch.cat([hsv[..., :1], torch.clamp(hsv[..., 1:2] * c + shift,
                                               0, 1), hsv[..., 2:]], -1)
    return _clip01(_hsv_to_rgb(hsv)) * 255.0


def linear_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) f32 weights of `jax.image.resize(method="linear")`
    along one axis: a triangle kernel widened by the scale when
    downscaling (antialiased), columns renormalized, samples outside
    [-0.5, n_in - 0.5] zeroed; half-pixel centres. Computed in f32 as
    jax's own weights are."""
    f32 = np.float32
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = f32(max(inv_scale, 1.0))
    sample_f = ((np.arange(n_out, dtype=f32) + f32(0.5)) * f32(inv_scale)
                - f32(0.0) - f32(0.5))
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / kernel_scale
    weights = np.maximum(f32(0.0), f32(1.0) - x)
    total = weights.sum(axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                       weights / np.where(total != 0, total, f32(1.0)),
                       f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], weights, f32(0.0)).T.astype(f32)


def nearest_resize_index(n_in: int, n_out: int) -> np.ndarray:
    """Source index per output position of `jax.image.resize(method=
    "nearest")`: floor((i + 0.5) * n_in / n_out) in f32."""
    f32 = np.float32
    off = (np.arange(n_out, dtype=f32) + f32(0.5)) * f32(n_in) / f32(n_out)
    return np.floor(off.astype(f32)).astype(np.int64)


def _resize_linear(x: torch.Tensor, h_out: int, w_out: int) -> torch.Tensor:
    """`jax.image.resize(..., "linear")` over axes 1 and 2 of (B, H, W) or
    (B, H, W, C): one matmul per axis with cached weight matrices."""
    h, w = x.shape[1], x.shape[2]
    mh, mw = (_const(("resize_linear", (n,), m, str(x.device)),
                     lambda n=n, m=m: _on(linear_resize_matrix(n, m).astype(
                         np.float64), x.device)) if n != m else None
              for n, m in ((h, h_out), (w, w_out)))
    x = x.to(torch.float64)
    if mh is not None:
        x = torch.einsum("oh,bh...->bo...", mh, x)
    if mw is not None:
        x = torch.einsum("pw,bhw...->bhp...", mw, x)
    return x.to(torch.float32)


def pixelate(x, severity):
    c = [0.6, 0.5, 0.4, 0.3, 0.25][severity - 1]
    b, h, w, ch = x.shape
    h2, w2 = max(1, int(h * c)), max(1, int(w * c))
    # PIL BOX downscale ~ area averaging; NEAREST upscale back
    small = _resize_linear(x, h2, w2)
    ih, iw = (_const(("resize_nearest", (n,), m, str(x.device)),
                     lambda n=n, m=m: _on(nearest_resize_index(n, m),
                                          x.device))
              for n, m in ((h2, h), (w2, w)))
    return small.index_select(1, ih).index_select(2, iw)


def _bilinear_sample(img, ys, xs, include_edge):
    """Per-image bilinear gather at float coords (B, H, W), reflect
    borders. img: (B, H, W, C)."""
    b, h, w, ch = img.shape
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = (ys - y0)[..., None]
    wx = (xs - x0)[..., None]
    y0 = y0.to(torch.int64)
    x0 = x0.to(torch.int64)
    flat = img.reshape(b, h * w, ch)

    def g(yy, xx):
        yy = _reflect_index(yy, h, include_edge)
        xx = _reflect_index(xx, w, include_edge)
        idx = (yy * w + xx).reshape(b, -1, 1).expand(b, h * w, ch)
        return flat.gather(1, idx).view(b, h, w, ch)

    return (g(y0, x0) * (1 - wx) * (1 - wy)
            + g(y0, x0 + 1) * wx * (1 - wy)
            + g(y0 + 1, x0) * (1 - wx) * wy
            + g(y0 + 1, x0 + 1) * wx * wy)


ELASTIC_CONSTANTS = [
    (244 * 2, 244 * 0.7, 244 * 0.1),
    (244 * 2, 244 * 0.08, 244 * 0.2),
    (244 * 0.05, 244 * 0.01, 244 * 0.02),
    (244 * 0.07, 244 * 0.01, 244 * 0.02),
    (244 * 0.12, 244 * 0.01, 244 * 0.02),
]


def elastic_points(h, w):
    """The affine-jitter correspondence triangle. The source passes
    (row, col) pairs where cv2 expects (x, y); the quirk is kept verbatim:
    pts are just an arbitrary correspondence basis."""
    cy, cx = float(np.float32(h) // 2), float(np.float32(w) // 2)
    s = float(min(h, w) // 3)
    return np.asarray(
        [[cy + s, cx + s], [cy + s, cx - s], [cy - s, cx - s]], np.float32
    )


def _elastic_inverse(delta: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, 3, 3) inverse of the affine that moves `elastic_points` by
    `delta` (B, 3, 2): cv2.getAffineTransform then warpAffine's dst->src."""
    b = delta.shape[0]
    pts1 = _on(elastic_points(h, w), delta.device)
    a_mat = torch.cat([pts1, torch.ones(3, 1, device=delta.device)], 1)
    sol = torch.linalg.solve(a_mat.expand(b, 3, 3), pts1[None] + delta)
    last = torch.tensor([[0.0, 0.0, 1.0]], device=delta.device)
    fwd = torch.cat([sol.transpose(1, 2), last.expand(b, 1, 3)], 1)
    return torch.linalg.inv(fwd)


def _elastic_fields(noise_dx, noise_dy, alpha, sigma):
    """Smoothed displacement fields (scipy gaussian truncate=3,
    mode='reflect' == symmetric) times alpha: (B, H, W) each."""
    return tuple(_sep_blur(n, sigma, truncate=3.0, mode="symmetric")[..., 0]
                 * alpha for n in (noise_dx, noise_dy))


def _elastic_sample(x01, inv, dx, dy):
    """Affine warp (BORDER_REFLECT_101) then the displacement sample
    (scipy map_coordinates order 1, mode 'reflect'); inv, dx, dy may carry
    a batch of 1 that serves every image."""
    b, h, w, _ = x01.shape
    yy = torch.arange(h, dtype=torch.float32, device=x01.device)[None, :, None]
    xx = torch.arange(w, dtype=torch.float32, device=x01.device)[None, None, :]

    def coef(i, j):
        return inv[:, i, j, None, None]

    sx = coef(0, 0) * xx + coef(0, 1) * yy + coef(0, 2)
    sy = coef(1, 0) * xx + coef(1, 1) * yy + coef(1, 2)
    warped = _bilinear_sample(x01, sy.expand(b, h, w), sx.expand(b, h, w),
                              include_edge=False)
    ys = (yy + dy).expand(b, h, w)
    xs = (xx + dx).expand(b, h, w)
    return _clip01(_bilinear_sample(warped, ys, xs, include_edge=True))


def _elastic_draws_exact(h: int, w: int, severity: int):
    """The reference render's elastic draws on the seed-1 stream, in its
    consumption order: affine-jitter uniform(-c2, c2, (3, 2)) first, then
    the raw dx uniform(-1, 1, (h, w)) field, then dy."""
    alpha, sigma, jitter = ELASTIC_CONSTANTS[severity - 1]
    rng = np.random.RandomState(1)
    delta = rng.uniform(-jitter, jitter, size=(3, 2)).astype(np.float32)
    ndx = rng.uniform(-1, 1, size=(h, w)).astype(np.float32)
    ndy = rng.uniform(-1, 1, size=(h, w)).astype(np.float32)
    return delta, ndx, ndy


def elastic_transform_exact(x, severity):
    """The seed-1 draws, shared by every image of the shape as in a
    reference-rendered tree; the inverse affine and the smoothed fields are
    constants of the shape."""
    _, h, w, _ = x.shape
    alpha, sigma, _ = ELASTIC_CONSTANTS[severity - 1]

    def build():
        delta, ndx, ndy = _elastic_draws_exact(h, w, severity)
        inv = _elastic_inverse(torch.from_numpy(delta)[None], h, w)
        dx, dy = _elastic_fields(_on(ndx[None, ..., None], x.device),
                                 _on(ndy[None, ..., None], x.device),
                                 alpha, sigma)
        return inv.to(x.device), dx, dy

    inv, dx, dy = _const(("elastic", (h, w), severity, str(x.device)), build)
    return _elastic_sample(_div(x, 255.0), inv, dx, dy) * 255.0


def draw_elastic_transform(x, severity, g):
    """Affine jitter uniform(-c2, c2) (B, 3, 2) and raw fields uniform(-1,
    1) (B, H, W, 1) for dx and dy."""
    _, _, jitter = ELASTIC_CONSTANTS[severity - 1]
    b, h, w, _ = x.shape
    return dict(delta=(_rand((b, 3, 2), g) * 2 - 1) * jitter,
                noise_dx=_rand((b, h, w, 1), g) * 2 - 1,
                noise_dy=_rand((b, h, w, 1), g) * 2 - 1)


def elastic_transform(x, severity, delta, noise_dx, noise_dy):
    """ImageNet-C elastic: random affine jitter of a center-square triangle
    (cv2.getAffineTransform + warpAffine BORDER_REFLECT_101) followed by a
    Gaussian-smoothed displacement field (the 244-scale (alpha, sigma,
    affine-jitter) triples, truncate=3 blur as in the scipy call)."""
    _, h, w, _ = x.shape
    alpha, sigma, _ = ELASTIC_CONSTANTS[severity - 1]
    dx, dy = _elastic_fields(noise_dx, noise_dy, alpha, sigma)
    inv = _elastic_inverse(delta, h, w)
    return _elastic_sample(_div(x, 255.0), inv, dx, dy) * 255.0


# JPEG via on-device DCT quantization --------------------------------------

_JPEG_LUMA_Q = np.array(
    [
        [16, 11, 10, 16, 24, 40, 51, 61],
        [12, 12, 14, 19, 26, 58, 60, 55],
        [14, 13, 16, 24, 40, 57, 69, 56],
        [14, 17, 22, 29, 51, 87, 80, 62],
        [18, 22, 37, 56, 68, 109, 103, 77],
        [24, 35, 55, 64, 81, 104, 113, 92],
        [49, 64, 78, 87, 103, 121, 120, 101],
        [72, 92, 95, 98, 112, 100, 103, 99],
    ],
    np.float32,
)

_JPEG_CHROMA_Q = np.array(
    [
        [17, 18, 24, 47, 99, 99, 99, 99],
        [18, 21, 26, 66, 99, 99, 99, 99],
        [24, 26, 56, 99, 99, 99, 99, 99],
        [47, 66, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
    ],
    np.float32,
)


def _quality_scale(q: int) -> float:
    return 5000.0 / q if q < 50 else 200.0 - 2.0 * q


def _dct_mat() -> np.ndarray:
    m = np.zeros((8, 8), np.float64)
    for k in range(8):
        for n in range(8):
            m[k, n] = math.cos(math.pi * k * (2 * n + 1) / 16.0)
    m *= 0.5
    m[0] *= 1.0 / math.sqrt(2.0)
    return m.astype(np.float32)


def _jpeg_channel(x, qtable):
    """x: (B, H, W) in [0, 255], H and W multiples of 8: 8x8 DCT,
    quantize with `qtable`, inverse DCT."""
    b, h, w = x.shape
    d = _const(("dct", (), str(x.device)),
               lambda: _on(_dct_mat().astype(np.float64), x.device))
    blocks = (x - 128.0).reshape(b, h // 8, 8, w // 8, 8).transpose(2, 3) \
        .reshape(-1, 8, 8).to(torch.float64)
    # TF32 perturbs DCT coefficients by ~1, enough to flip
    # `round(coeff / qt)` quantization bins; the products are summed in
    # f64 and each stage rounded to f32
    coeff = torch.matmul(torch.matmul(d, blocks), d.T).to(torch.float32)
    quant = torch.round(coeff / qtable) * qtable
    rec = torch.matmul(torch.matmul(d.T, quant.to(torch.float64)), d)
    return rec.to(torch.float32).reshape(b, h // 8, w // 8, 8, 8) \
        .transpose(2, 3).reshape(b, h, w) + 128.0


def _jpeg_tables(severity: int, device):
    def build():
        q = [25, 18, 15, 10, 7][severity - 1]
        scale = _quality_scale(q)
        luma = np.clip(np.floor((_JPEG_LUMA_Q * scale + 50) / 100), 1, 255)
        chroma = np.clip(np.floor((_JPEG_CHROMA_Q * scale + 50) / 100), 1,
                         255)
        return _on(luma.astype(np.float32), device), _on(
            chroma.astype(np.float32), device)

    return _const(("jpeg_tables", (), severity, str(device)), build)


def jpeg_compression(x, severity):
    """libjpeg's encode/decode replaced by DCT quantization with the
    standard tables at quality 25/18/15/10/7, YCbCr 4:2:0."""
    luma_q, chroma_q = _jpeg_tables(severity, x.device)
    b, h, w, _ = x.shape
    ph = (16 - h % 16) % 16
    pw = (16 - w % 16) % 16
    hp, wp = h + ph, w + pw
    ih, iw = (_const(("edge_index", (n,), n + p, str(x.device)),
                     lambda n=n, p=p: _on(np.minimum(np.arange(n + p), n - 1),
                                          x.device))
              for n, p in ((h, ph), (w, pw)))
    xp = x.index_select(1, ih).index_select(2, iw)
    r, g, bl = xp.unbind(-1)
    y = 0.299 * r + 0.587 * g + 0.114 * bl
    cb = -0.168736 * r - 0.331264 * g + 0.5 * bl + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * bl + 128.0

    y = _jpeg_channel(y, luma_q)

    def sub(c):  # 4:2:0 chroma subsampling
        c2 = _jpeg_channel(_resize_linear(c, hp // 2, wp // 2), chroma_q)
        return _resize_linear(c2, hp, wp)

    cb = sub(cb)
    cr = sub(cr)
    r = y + 1.402 * (cr - 128.0)
    g = y - 0.344136 * (cb - 128.0) - 0.714136 * (cr - 128.0)
    bl = y + 1.772 * (cb - 128.0)
    out = torch.stack([r, g, bl], dim=-1)[:, :h, :w, :]
    return torch.clamp(torch.round(out), 0, 255)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

# order of get_corruption_names() in imagecorruptions: the 15 benchmark
# types first (they alone make mPC)
BENCHMARK_CORRUPTIONS = [
    "gaussian_noise", "shot_noise", "impulse_noise",
    "defocus_blur", "glass_blur", "motion_blur", "zoom_blur",
    "snow", "frost", "fog", "brightness",
    "contrast", "elastic_transform", "pixelate", "jpeg_compression",
]
HOLDOUT_CORRUPTIONS = ["speckle_noise", "gaussian_blur", "spatter", "saturate"]
ALL_CORRUPTIONS = BENCHMARK_CORRUPTIONS + HOLDOUT_CORRUPTIONS

# name -> apply function; the random ones take the draws of DRAWS[name]
CORRUPTIONS = {
    "gaussian_noise": gaussian_noise,
    "shot_noise": shot_noise,
    "impulse_noise": impulse_noise,
    "defocus_blur": defocus_blur,
    "glass_blur": glass_blur,
    "motion_blur": motion_blur,
    "zoom_blur": zoom_blur,
    "snow": snow,
    "frost": frost,
    "fog": fog,
    "brightness": brightness,
    "contrast": contrast,
    "elastic_transform": elastic_transform,
    "pixelate": pixelate,
    "jpeg_compression": jpeg_compression,
    "speckle_noise": speckle_noise,
    "gaussian_blur": gaussian_blur,
    "spatter": spatter,
    "saturate": saturate,
}

DRAWS = {
    "gaussian_noise": draw_gaussian_noise,
    "shot_noise": draw_shot_noise,
    "impulse_noise": draw_impulse_noise,
    "speckle_noise": draw_speckle_noise,
    "glass_blur": draw_glass_blur,
    "motion_blur": draw_motion_blur,
    "snow": draw_snow,
    "frost": draw_frost,
    "fog": draw_fog,
    "elastic_transform": draw_elastic_transform,
    "spatter": draw_spatter,
}

# Render-path (pre-rendered -C dataset) forms: the reference seeds
# np.random.seed(1) before every corrupt call, so each render's draws are a
# pure function of (corruption, severity, image shape), replayed on the
# host with the same MT19937 stream. Deliberately not stream-matched
# (distribution-level by design, as in the JAX package): the four iid
# noises and fog's plasma; frost without a texture directory.
EXACT_RENDER = {
    "glass_blur": lambda x, s, g: glass_blur_exact(x, s),
    "motion_blur": lambda x, s, g: motion_blur_exact(x, s),
    "snow": lambda x, s, g: snow_exact(x, s),
    "elastic_transform": lambda x, s, g: elastic_transform_exact(x, s),
    "spatter": lambda x, s, g: spatter_exact(x, s),
    "frost": frost_exact,
}


def corrupt(x: torch.Tensor, name: str, severity: int,
            generator: torch.Generator | None = None,
            exact_render: bool = False) -> torch.Tensor:
    """Apply a corruption by name. x: (B, H, W, 3) float [0, 255] on any
    device; severity 1..5. `generator` drives the random forms (None: a
    generator seeded 1 on x's device, a deterministic render; a generator
    on another device seeds one on x's). exact_render=True selects the
    pre-rendered-dataset semantics where they differ (EXACT_RENDER): used
    by the renderer and the on-the-fly eval sweep so their bits match a
    reference-rendered -C tree."""
    if name not in CORRUPTIONS:
        raise KeyError(f"unknown corruption '{name}'")
    if not 1 <= severity <= 5:
        raise ValueError(f"severity must be 1..5, got {severity}")
    if exact_render and name in EXACT_RENDER:
        return EXACT_RENDER[name](x, severity,
                                  device_generator(generator, x.device))
    if name in DRAWS:
        g = device_generator(generator, x.device)
        return CORRUPTIONS[name](x, severity, **DRAWS[name](x, severity, g))
    return CORRUPTIONS[name](x, severity)
