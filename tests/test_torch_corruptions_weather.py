"""The port's weather corruptions (fog, frost, snow, spatter) against the
JAX package's, on the same numpy images (B=2, 32x24).

Tolerances, on the [0, 255] scale: |diff| <= 1e-3; snow rounds its layer
to uint8 inside, and spatter's mud arm thresholds a blurred field, so for
those the share of values off by more than 1e-3 must stay <= 0.5%
(measured: 0 for snow; spatter's worst |diff| 7.6e-6). The random forms
take the JAX package's draws (`torch_corruption_util.jax_draws`).
"""

import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import advmix_tpu.ops.corruptions as J
import advmix_tpu_torch.ops.corruptions as T
from torch_corruption_util import agreement, image, jax_draws

SEVERITIES = [1, 2, 3, 4, 5]
ROUNDED = {"snow", "spatter"}


def check(got, want, name):
    worst, share, _ = agreement(got, want)
    if name in ROUNDED:
        assert share <= 0.005, (worst, share)
    else:
        assert worst <= 1e-3, worst


@pytest.mark.parametrize("severity", SEVERITIES)
@pytest.mark.parametrize("name", ["snow", "spatter"])
def test_exact_render_forms_match_jax(name, severity):
    """The seed-1 snow layer; spatter's mud mask (4-5) and the cv2 water
    chain (1-3)."""
    x = image(10)
    want = J.corrupt(jnp.asarray(x), name, severity, exact_render=True)
    got = T.corrupt(torch.from_numpy(x), name, severity, exact_render=True)
    check(got, want, name)


@pytest.mark.parametrize("severity", SEVERITIES)
@pytest.mark.parametrize("name", ["fog", "frost", "snow", "spatter"])
def test_random_forms_match_jax_on_its_draws(name, severity):
    """fog and the procedural frost run the plasma fractal batched over the
    images, where the JAX package loops over them."""
    x = image(11)
    key = jax.random.PRNGKey(200 + severity)
    want = J.CORRUPTIONS[name](jnp.asarray(x), severity, key)
    got = T.CORRUPTIONS[name](torch.from_numpy(x), severity,
                              **jax_draws(name, x, severity, key))
    check(got, want, name)


def test_exact_frost_without_textures_is_the_procedural_form():
    """No texture directory: exact_render frost is the procedural texture,
    driven by the generator (as the JAX package falls back to its key)."""
    x = torch.from_numpy(image(12))
    a = T.corrupt(x, "frost", 3, torch.Generator().manual_seed(4),
                  exact_render=True)
    b = T.corrupt(x, "frost", 3, torch.Generator().manual_seed(4))
    assert torch.equal(a, b)


@pytest.fixture
def frost_textures(tmp_path):
    """Six seeded texture photographs, smaller and larger than the crop."""
    rng = np.random.RandomState(0)
    for i, (h, w) in enumerate([(20, 30), (40, 20), (50, 60), (28, 22),
                                (33, 35), (64, 48)]):
        cv2.imwrite(str(tmp_path / f"frost{i}.png"),
                    rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
    J.set_frost_texture_dir(str(tmp_path))
    T.set_frost_texture_dir(str(tmp_path))
    T.release_constants()
    yield
    J.set_frost_texture_dir(None)
    T.set_frost_texture_dir(None)
    T.release_constants()


@pytest.mark.parametrize("severity", [1, 5])
def test_frost_texture_bank_matches_jax(frost_textures, severity):
    """The published algorithm with a texture directory: the seed-1 crop
    (exact) and per-image crops from the JAX draws."""
    x = image(13)
    want = J.corrupt(jnp.asarray(x), "frost", severity, exact_render=True)
    got = T.corrupt(torch.from_numpy(x), "frost", severity,
                    exact_render=True)
    check(got, want, "frost")
    key = jax.random.PRNGKey(7)
    k_i, k_y, k_x = jax.random.split(key, 3)
    n_tex = J._frost_bank(32, 24)[0].shape[0]
    draws = dict(
        tex_idx=torch.from_numpy(np.array(
            jax.random.randint(k_i, (2,), 0, n_tex))).long(),
        u_y=torch.from_numpy(np.array(jax.random.uniform(k_y, (2,)))),
        u_x=torch.from_numpy(np.array(jax.random.uniform(k_x, (2,)))))
    want = J.frost(jnp.asarray(x), severity, key)
    got = T.frost(torch.from_numpy(x), severity, **draws)
    check(got, want, "frost")


def test_exact_spatter_water_without_cv2_names_it(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    T.release_constants()
    x = torch.from_numpy(image(14))
    with pytest.raises(ImportError, match="severities 1-3.*cv2"):
        T.corrupt(x, "spatter", 2, exact_render=True)
    # the mud arm and the traced water arm need no cv2
    T.corrupt(x, "spatter", 4, exact_render=True)
    T.corrupt(x, "spatter", 2)


def test_plasma_is_batched_over_the_images():
    """One batched plasma run equals the JAX package's per-image loop."""
    key = jax.random.PRNGKey(3)
    keys = jax.random.split(key, 3)
    from torch_corruption_util import _plasma_noises

    noises = _plasma_noises(keys, 32, 1.7)
    got = T._plasma_core(noises, 32).numpy()
    for i, k in enumerate(keys):
        want = np.asarray(J._plasma_fractal(k, 32, 1.7))
        np.testing.assert_allclose(got[i], want, rtol=0, atol=1e-6)
