"""The port's associative-embedding ops (`advmix_tpu_torch/ops/ae.py`) and
the bottom-up steps' `_mask_at` against the JAX package's, on the same
seeded numpy inputs (the port's maps are NCHW where the JAX ones are NHWC).

Tolerances: Gaussian targets within 1e-6 (values in [0, 1], f32 `exp` on
both sides) and their integer locations equal; the AE pull and push and
the masked heatmap MSE within rtol 1e-6 in f32 and 1e-12 in float64; the
top-k peaks equal, ties included (the NMS leaves most of a map exactly 0,
and the port's stable descending sort keeps `lax.top_k`'s lowest-index-
first order); the aggregated maps within 1e-6 of the largest magnitude
(bilinear upsampling; antialiased downsampling, as `jax.image.resize`).
`_mask_at` re-binarizes a resized 0/1 mask at 0.5: pixels whose resized
value is within 1e-6 of 0.5 are ties, which float rounding may send
either way; every other pixel must be equal. A 2x shrink of a random mask
makes ~5% of its pixels ties and the two packages then differ on under
0.1% of all pixels (0.07% here); a mask of blocks, as COCO's crowd regions
give, has under 1% ties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import enable_x64

from advmix_tpu.engine.steps import _mask_at as jax_mask_at
from advmix_tpu.ops import ae as jae
from advmix_tpu_torch.engine.steps import _mask_at
from advmix_tpu_torch.ops import ae

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _nhwc_to_nchw(a):
    return np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2))


def _people(rng, b=2, m=4, j=5, extent=16.0):
    joints = rng.uniform(-4, extent + 4, (b, m, j, 2)).astype(np.float32)
    vis = (rng.rand(b, m, j) > 0.3).astype(np.float32)
    vis[0, -1] = 0.0  # a person with no visible joint
    vis[1, 1:] = 0.0  # an image of one person
    return joints, vis


@pytest.mark.parametrize("sigma", [2, 3])
def test_generate_bottomup_target_matches_jax(sigma):
    rng = np.random.RandomState(sigma)
    joints, vis = _people(rng, extent=20.0)
    tgt_j, locs_j = jae.generate_bottomup_target(
        jnp.asarray(joints), jnp.asarray(vis), (20, 16), sigma)
    tgt, locs = ae.generate_bottomup_target(_t(joints), _t(vis), (20, 16),
                                            sigma)
    assert tuple(tgt.shape) == (2, 5, 16, 20) and tgt.dtype == torch.float32
    assert float(tgt.max()) == 1.0
    np.testing.assert_allclose(tgt.numpy(), _nhwc_to_nchw(tgt_j), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(locs.numpy(), np.asarray(locs_j))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_ae_loss_matches_jax(dtype):
    rng = np.random.RandomState(1)
    joints, vis = _people(rng, b=3, m=5, j=5)
    tags = rng.randn(3, 16, 16, 5).astype(dtype)
    locs = np.clip(np.trunc(joints + 0.5), 0, 15).astype(np.int32)
    with enable_x64(dtype == "float64"):
        pull_j, push_j = jae.ae_loss(jnp.asarray(tags), jnp.asarray(locs),
                                     jnp.asarray(vis))
        want = [float(pull_j), float(push_j)]
    pull, push = ae.ae_loss(_t(tags.transpose(0, 3, 1, 2)), _t(locs),
                            _t(vis))
    assert pull.dtype == getattr(torch, dtype)
    assert min(want) > 0  # every term is exercised
    np.testing.assert_allclose([float(pull), float(push)], want,
                               rtol=1e-6 if dtype == "float32" else 1e-12)


@pytest.mark.parametrize("masked", [False, True])
def test_bottomup_heatmap_loss_matches_jax(masked):
    rng = np.random.RandomState(2)
    pred = rng.randn(2, 12, 12, 5).astype(np.float32)
    target = rng.rand(2, 12, 12, 5).astype(np.float32)
    mask = (rng.rand(2, 12, 12) > 0.4).astype(np.float32) if masked \
        else None
    want = float(jae.bottomup_heatmap_loss(
        jnp.asarray(pred), jnp.asarray(target),
        None if mask is None else jnp.asarray(mask)))
    got = float(ae.bottomup_heatmap_loss(
        _t(pred.transpose(0, 3, 1, 2)), _t(target.transpose(0, 3, 1, 2)),
        None if mask is None else _t(mask)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("tdim", [1, 2])
def test_top_k_peaks_matches_jax_ties_included(tdim):
    """8x8 maps, half zeros, k=30: past the NMS survivors the top-k is all
    exact-0 ties, and the indices must agree one by one."""
    rng = np.random.RandomState(3 + tdim)
    heat = np.maximum(rng.randn(2, 8, 8, 5), 0).astype(np.float32)
    heat[0, 2:4, 2:4, 1] = 0.7  # a plateau: equal neighbours survive
    tags = rng.randn(2, 8, 8, 5, 2).astype(np.float32)
    if tdim == 1:
        tags = tags[..., 0]
    want = jae.top_k_peaks(jnp.asarray(heat), jnp.asarray(tags), k=30)
    tags_port = (tags.transpose(0, 3, 1, 2) if tdim == 1
                 else tags.transpose(0, 3, 1, 2, 4))
    got = ae.top_k_peaks(_t(heat.transpose(0, 3, 1, 2)), _t(tags_port), k=30)
    assert int((got["val"] == 0).sum()) > 30  # ties at 0 are compared
    for key in ("x", "y", "val", "tag"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)


@pytest.mark.parametrize("target_hw", [(32, 32), (16, 16), (8, 8)])
def test_aggregate_heatmaps_matches_jax(target_hw):
    """(32, 32) upsamples the 1/4 head, (16, 16) downsamples the 1/2 head
    (the multi-scale test's scale 2), (8, 8) downsamples both."""
    rng = np.random.RandomState(4)
    outs = [rng.randn(2, 16, 16, 10).astype(np.float32),
            rng.randn(2, 32, 32, 5).astype(np.float32)]
    heat_j, tags_j = jae.aggregate_heatmaps([jnp.asarray(o) for o in outs],
                                            target_hw)
    heat, tags = ae.aggregate_heatmaps([_t(_nhwc_to_nchw(o)) for o in outs],
                                       target_hw)
    for got, want in ((heat, heat_j), (tags, tags_j)):
        want = _nhwc_to_nchw(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("kind", ["random", "blocks"])
@pytest.mark.parametrize("hw", [(16, 16), (32, 32)])
def test_mask_at_matches_jax_outside_ties(kind, hw):
    rng = np.random.RandomState(5)
    if kind == "random":
        mask = (rng.rand(3, 64, 64) > 0.5).astype(np.float32)
    else:  # ignore regions as COCO's crowd boxes give them
        mask = np.ones((3, 64, 64), np.float32)
        for b in range(3):
            y, x = rng.randint(0, 48, 2)
            mask[b, y:y + rng.randint(4, 17), x:x + rng.randint(4, 17)] = 0
    want = np.asarray(jax_mask_at(jnp.asarray(mask), *hw))
    soft = np.asarray(jax.image.resize(jnp.asarray(mask), (3, *hw),
                                       method="linear"))
    got = _mask_at(_t(mask), *hw).numpy()
    ties = np.abs(soft - 0.5) <= 1e-6
    # a 2x shrink of a random 0/1 mask lands ~5% of its pixels on 0.5
    share = ties.mean()
    assert share <= (0.05 if kind == "random" else 0.01), share
    np.testing.assert_array_equal(got[~ties], want[~ties])
    assert (got != want).mean() <= 0.001
    assert _mask_at(None, *hw) is None
    same = _t(mask)
    assert _mask_at(same, 64, 64) is same
