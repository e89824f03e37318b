"""The port's digital corruptions (brightness, contrast, saturate,
pixelate, elastic_transform, jpeg_compression) against the JAX package's,
on the same numpy images (B=2, 32x24), and the resize weights against
`jax.image.resize`.

Tolerances, on the [0, 255] scale: |diff| <= 1e-3; JPEG rounds its DCT
coefficients and its output, so there the share of values off by more
than 1e-3 must stay <= 0.5% (measured: 0). elastic_transform is held in
its parts: at this size the affine-jitter triangle (side 8 px) is smaller
than the jitter (up to 48.8 px), so the 3x3 solve is ill-conditioned and
f32 solves of two libraries differ by ~1e-3 in the matrix; and alpha = 488
amplifies the f32 rounding of the smoothed fields. So the inverse matrices
agree to 2e-3 of their largest entry, the fields to 1e-4 px, and the
sampling fed the JAX package's matrix and fields to 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import advmix_tpu.ops.corruptions as J
import advmix_tpu_torch.ops.corruptions as T
from torch_corruption_util import agreement, image, jax_draws, t

SEVERITIES = [1, 2, 3, 4, 5]


@pytest.mark.parametrize("severity", SEVERITIES)
@pytest.mark.parametrize("name", ["brightness", "contrast", "saturate",
                                  "pixelate", "jpeg_compression"])
def test_deterministic_forms_match_jax(name, severity):
    x = image(20)
    want = J.corrupt(jnp.asarray(x), name, severity)
    got = T.corrupt(torch.from_numpy(x), name, severity)
    worst, share, _ = agreement(got, want)
    if name == "jpeg_compression":
        assert share <= 0.005, (worst, share)
    else:
        assert worst <= 1e-3, worst


def jax_elastic_parts(x01, delta, ndx, ndy, severity):
    """The JAX package's inverse affine and smoothed fields for these
    draws, and its output."""
    b, h, w, _ = x01.shape
    alpha, sigma, _ = J.ELASTIC_CONSTANTS[severity - 1]
    pts1 = jnp.asarray(J.elastic_points(h, w))
    a_mat = jnp.concatenate([pts1, jnp.ones((3, 1), jnp.float32)], axis=1)
    sol = jnp.linalg.solve(jnp.broadcast_to(a_mat, (b, 3, 3)),
                           pts1[None] + jnp.asarray(delta))
    last = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)[None],
                    (b, 1, 1))
    inv = jnp.linalg.inv(jnp.concatenate([sol.transpose(0, 2, 1), last], 1))
    dx, dy = (J._sep_blur(jnp.asarray(n), sigma, truncate=3.0,
                          mode="symmetric")[..., 0] * alpha
              for n in (ndx, ndy))
    out = J._elastic_core(jnp.asarray(x01), jnp.asarray(delta),
                          jnp.asarray(ndx), jnp.asarray(ndy), alpha, sigma)
    return t(inv), t(dx), t(dy), np.asarray(out)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("severity", SEVERITIES)
def test_elastic_matches_jax_in_its_parts(severity, exact):
    x = image(21)
    b, h, w, _ = x.shape
    alpha, sigma, _ = J.ELASTIC_CONSTANTS[severity - 1]
    if exact:
        delta, ndx, ndy = J._elastic_draws_exact(h, w, severity)
        assert all(np.array_equal(a, c) for a, c in zip(
            (delta, ndx, ndy), T._elastic_draws_exact(h, w, severity)))
        delta = np.broadcast_to(delta, (b, 3, 2))
        ndx = np.broadcast_to(ndx[None, ..., None], (b, h, w, 1))
        ndy = np.broadcast_to(ndy[None, ..., None], (b, h, w, 1))
    else:
        d = jax_draws("elastic_transform", x, severity,
                      jax.random.PRNGKey(300 + severity))
        delta, ndx, ndy = (d[k].numpy() for k in ("delta", "noise_dx",
                                                   "noise_dy"))
    inv, dx, dy, want = jax_elastic_parts(x / 255.0, delta, ndx, ndy,
                                          severity)
    got_inv = T._elastic_inverse(t(delta), h, w)
    assert float((got_inv - inv).abs().max()) <= 2e-3 * float(
        inv.abs().max())
    got_dx, got_dy = T._elastic_fields(t(ndx), t(ndy), alpha, sigma)
    assert float((got_dx - dx).abs().max()) <= 1e-4
    assert float((got_dy - dy).abs().max()) <= 1e-4
    got = T._elastic_sample(torch.from_numpy(x / 255.0), inv, dx, dy)
    np.testing.assert_allclose(got.numpy() * 255.0, want * 255.0, rtol=0,
                               atol=1e-3)
    # the whole corruption runs and stays in range
    whole = (T.corrupt(torch.from_numpy(x), "elastic_transform", severity,
                       exact_render=True) if exact else
             T.elastic_transform(torch.from_numpy(x), severity,
                                 t(delta), t(ndx), t(ndy)))
    assert whole.shape == x.shape and float(whole.min()) >= 0 and float(
        whole.max()) <= 255


@pytest.mark.parametrize("n_in,n_out", [(32, 19), (24, 14), (32, 8),
                                        (16, 32), (7, 12), (25, 10)])
def test_resize_weights_match_jax_image_resize(n_in, n_out):
    """Linear (antialiased when shrinking) and nearest, one axis at a
    time and both together."""
    x = np.random.RandomState(n_in * n_out).rand(2, n_in, n_in + 3, 3) \
        .astype(np.float32)
    for method in ("linear", "nearest"):
        shape = (2, n_out, n_in + 3, 3)
        want = np.asarray(jax.image.resize(jnp.asarray(x), shape, method))
        if method == "linear":
            got = np.einsum("oh,bhwc->bowc",
                            T.linear_resize_matrix(n_in, n_out), x)
        else:
            got = x[:, T.nearest_resize_index(n_in, n_out)]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    shape = (2, n_out, n_out + 1, 3)
    want = np.asarray(jax.image.resize(jnp.asarray(x), shape, "linear"))
    got = T._resize_linear(torch.from_numpy(x), n_out, n_out + 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_hsv_round_trip_matches_jax():
    x = image(22) / 255.0
    x[0, :4] = x[0, :4, :, :1]  # grey pixels: zero saturation, zero hue
    want = np.asarray(J._rgb_to_hsv(jnp.asarray(x)))
    got = T._rgb_to_hsv(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    back = T._hsv_to_rgb(got)
    np.testing.assert_allclose(
        back.numpy(), np.asarray(J._hsv_to_rgb(jnp.asarray(want))), rtol=0,
        atol=1e-6)
    np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=1e-5)


def test_unknown_name_and_severity_raise():
    x = torch.zeros(1, 8, 8, 3)
    with pytest.raises(KeyError):
        T.corrupt(x, "rain", 1)
    with pytest.raises(ValueError):
        T.corrupt(x, "contrast", 6)
