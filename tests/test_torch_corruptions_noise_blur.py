"""The port's noise and blur corruptions against the JAX package's, on the
same numpy images (B=2, 32x24, uint8 values as f32).

Tolerances, on the [0, 255] scale:
- deterministic forms (every severity): |diff| <= 1e-3. glass_blur
  truncates to uint8 between its two blurs: there the share of values off
  by more than 1e-3 must stay <= 0.5% (measured: 0 at this size);
- random forms: the JAX package's draws, replayed from its key splits
  (`torch_corruption_util.jax_draws`), fed to the port's apply; same
  tolerances (measured: the noises and motion streaks equal to the bit);
- the port's own draws at distribution level (mean, std, rates);
- `glass_compose` (C++ and the Python loop) exactly equal to the JAX
  package's; the disk kernel within 1e-7 of cv2.GaussianBlur.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import advmix_tpu.ops.corruptions as J
import advmix_tpu_torch.ops.corruptions as T
from advmix_tpu.native import glass_compose as jax_glass_compose
from advmix_tpu_torch.native import glass_compose, glass_compose_py
from torch_corruption_util import agreement, image, jax_draws

SEVERITIES = [1, 2, 3, 4, 5]
ROUNDED = {"glass_blur"}  # a uint8 truncation sits inside


def check(got, want, name):
    worst, share, _ = agreement(got, want)
    if name in ROUNDED:
        assert share <= 0.005, (worst, share)
    else:
        assert worst <= 1e-3, worst


@pytest.mark.parametrize("severity", SEVERITIES)
@pytest.mark.parametrize("name", ["defocus_blur", "gaussian_blur",
                                  "zoom_blur", "glass_blur", "motion_blur"])
def test_deterministic_forms_match_jax(name, severity):
    """Key-free types and the exact-render forms of glass and motion."""
    x = image(1)
    want = J.corrupt(jnp.asarray(x), name, severity, exact_render=True)
    got = T.corrupt(torch.from_numpy(x), name, severity, exact_render=True)
    check(got, want, name)


@pytest.mark.parametrize("severity", SEVERITIES)
@pytest.mark.parametrize("name", ["gaussian_noise", "shot_noise",
                                  "impulse_noise", "speckle_noise",
                                  "glass_blur", "motion_blur"])
def test_random_forms_match_jax_on_its_draws(name, severity):
    x = image(2)
    key = jax.random.PRNGKey(100 + severity)
    want = J.CORRUPTIONS[name](jnp.asarray(x), severity, key)
    got = T.CORRUPTIONS[name](torch.from_numpy(x), severity,
                              **jax_draws(name, x, severity, key))
    check(got, want, name)


def test_port_draws_at_distribution_level():
    """The port's own draws: standard normals, Poisson counts of mean lam,
    an impulse rate of c split evenly into salt and pepper."""
    g = torch.Generator().manual_seed(0)
    x = torch.full((4, 64, 64, 3), 128.0)
    n = T.draw_gaussian_noise(x, 1, g)["n"]
    assert abs(float(n.mean())) < 0.01 and abs(float(n.std()) - 1) < 0.01
    n = T.draw_speckle_noise(x, 1, g)["n"]
    assert abs(float(n.mean())) < 0.01 and abs(float(n.std()) - 1) < 0.01
    counts = T.draw_shot_noise(x, 3, g)["counts"]
    lam = 128.0 / 255.0 * 12
    assert abs(float(counts.mean()) - lam) < 0.05 * lam
    assert abs(float(counts.var()) - lam) < 0.1 * lam
    out = T.corrupt(x, "impulse_noise", 5, g)
    changed = (out != x).any(-1)
    assert abs(float(changed.float().mean()) - 0.27) < 0.01
    salt = (out == 255.0).all(-1)
    assert abs(float(salt.float().mean()) - 0.135) < 0.01


def test_draws_follow_the_generator_seed():
    x = torch.from_numpy(image(3))
    for name in ("gaussian_noise", "glass_blur", "motion_blur"):
        a = T.corrupt(x, name, 3, torch.Generator().manual_seed(1))
        b = T.corrupt(x, name, 3, torch.Generator().manual_seed(1))
        c = T.corrupt(x, name, 3, torch.Generator().manual_seed(2))
        assert torch.equal(a, b) and not torch.equal(a, c), name


@pytest.mark.parametrize("severity", SEVERITIES)
def test_glass_compose_matches_jax(severity):
    _, md, iters = J.GLASS_CONSTANTS[severity - 1]
    h, w = 30, 22
    n = iters * len(range(h - md, md, -1)) * len(range(w - md, md, -1))
    deltas = np.random.RandomState(severity).randint(
        -md, md, size=(n, 2)).astype(np.int32)
    want = jax_glass_compose(h, w, md, iters, deltas)
    assert np.array_equal(glass_compose(h, w, md, iters, deltas), want)
    assert np.array_equal(glass_compose_py(h, w, md, iters, deltas), want)
    assert np.array_equal(T.glass_blur_permutation(h, w, severity),
                          J.glass_blur_permutation(h, w, severity))


@pytest.mark.parametrize("severity", SEVERITIES)
def test_disk_kernel_matches_cv2(severity):
    """The numpy disk kernel against cv2.GaussianBlur on the same aliased
    disk (ksize 3 or 5, BORDER_REFLECT_101, not renormalized)."""
    radius, alias = T._DEFOCUS[severity - 1]
    coords = np.arange(-8, 9) if radius <= 8 else np.arange(-radius,
                                                            radius + 1)
    xg, yg = np.meshgrid(coords, coords)
    aliased = np.array((xg**2 + yg**2) <= radius**2, dtype=np.float32)
    aliased /= aliased.sum()
    want = cv2.GaussianBlur(aliased, ksize=(3, 3) if radius <= 8 else (5, 5),
                            sigmaX=alias)
    got = T._disk_kernel(radius, alias)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


@pytest.mark.parametrize("mode", ["nearest", "symmetric", "mirror"])
@pytest.mark.parametrize("sigma", [1.5, 20.0])  # taps-wide conv; dense
def test_sep_blur_matches_jax(sigma, mode):
    x = image(4)[..., :1] / 255.0
    want = J._sep_blur(jnp.asarray(x), sigma, mode=mode)
    got = T._sep_blur(torch.from_numpy(x), sigma, mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-6)


def test_host_constants_are_built_once_per_shape(monkeypatch):
    """A second batch of the same shape reuses the seed-1 permutation and
    snow layer instead of redoing the MT19937 and scipy work; another
    shape builds its own; release_constants drops a shape's."""
    calls = []
    perm = T.glass_blur_permutation
    monkeypatch.setattr(T, "glass_blur_permutation",
                        lambda *a: calls.append(a) or perm(*a))
    T.release_constants()
    x = torch.from_numpy(image(5))
    for _ in range(3):
        T.corrupt(x, "glass_blur", 2, exact_render=True)
    assert len(calls) == 1
    T.corrupt(x[:, :16], "glass_blur", 2, exact_render=True)
    assert len(calls) == 2
    assert T.release_constants(32, 24) >= 1
    T.corrupt(x, "glass_blur", 2, exact_render=True)
    assert len(calls) == 3
