"""The port's numeric ops against the JAX package's, on seeded inputs.

Layouts: the port's heatmaps are NCHW (B, J, H, W), the JAX package's NHWC
(B, H, W, J); the tests transpose. Tolerances: exact where both sides do
the same f32 arithmetic; for the device inverse affine one f32 ulp of
pixel coordinates below 1024 (2**-14 = 6.1e-5 px), since XLA may fuse a
multiply-add that torch rounds twice and the translation term is ~500 px;
rtol 1e-6 for the losses, whose means sum in a different order.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from advmix_tpu.ops import heatmap as JH
from advmix_tpu.ops import losses as JL
from advmix_tpu.ops import transforms as JT
from advmix_tpu_torch.ops import heatmap as H
from advmix_tpu_torch.ops import losses as L
from advmix_tpu_torch.ops import transforms as T

ATOL_PX = 2.0**-14
PAIRS = [[1, 2], [3, 4], [5, 6], [7, 8], [9, 10], [11, 12], [13, 14],
         [15, 16]]


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t):
    return np.asarray(t).transpose(0, 2, 3, 1)


def heatmaps(seed, b=4, j=17, h=16, w=12):
    rng = np.random.RandomState(seed)
    hm = rng.rand(b, h, w, j).astype(np.float32)
    hm[0, :, :, 0] = 0.0  # all-zero map
    hm[1, :, :, 1] -= 2.0  # negative map
    hm[2, :, :, 2] = np.round(hm[2, :, :, 2] * 3) / 3  # exact ties
    for k, (py, px) in enumerate([(0, 0), (1, 5), (h - 1, w - 1),
                                  (h - 2, 1), (5, w - 2), (7, 6)]):
        hm[3, py, px, 3 + k] = 3.0  # peaks on and next to the border
    return hm


def test_flip_back_and_shift_match_jax():
    hm = heatmaps(0)
    np.testing.assert_array_equal(
        nhwc(T.flip_back(nchw(hm), PAIRS)),
        np.asarray(JT.flip_back(jnp.asarray(hm), PAIRS)))
    np.testing.assert_array_equal(
        nhwc(T.shift_heatmap_right(nchw(hm))),
        np.asarray(JT.shift_heatmap_right(jnp.asarray(hm))))


@pytest.mark.parametrize("sigma", [2, 3])
def test_generate_target_matches_jax(sigma):
    rng = np.random.RandomState(1)
    joints = rng.uniform(-60, 170, (5, 17, 2)).astype(np.float32)
    vis = (rng.rand(5, 17) > 0.2).astype(np.float32)
    got = H.generate_target(torch.from_numpy(joints), torch.from_numpy(vis),
                            (96, 128), (24, 32), sigma)
    want = JH.generate_target(jnp.asarray(joints), jnp.asarray(vis),
                              (96, 128), (24, 32), sigma)
    np.testing.assert_array_equal(nhwc(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[2].sum() < vis.sum()  # some windows fell off the map


def test_decode_ops_match_jax():
    hm = heatmaps(2)
    c, m = H.get_max_preds(nchw(hm))
    jc, jm = JH.get_max_preds(jnp.asarray(hm))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(
        H.quarter_offset(nchw(hm), c).numpy(),
        np.asarray(JH.quarter_offset(jnp.asarray(hm), jc)))


def test_get_max_preds_takes_first_of_ties():
    hm = np.zeros((1, 1, 4, 5), np.float32)
    hm[0, 0, 3, 0] = 1.0
    hm[0, 0, 1, 4] = 1.0  # earlier row, later column: row-major first
    c, m = H.get_max_preds(torch.from_numpy(hm))
    assert c[0, 0].tolist() == [4.0, 1.0] and m.item() == 1.0


def test_device_inverse_affine_matches_jax_and_host():
    rng = np.random.RandomState(3)
    center = rng.uniform(50, 600, (6, 2)).astype(np.float32)
    scale = rng.uniform(0.3, 2.5, (6, 2)).astype(np.float32)
    coords = rng.uniform(0, 48, (6, 17, 2)).astype(np.float32)
    got = T.transform_preds_batch(torch.from_numpy(coords),
                                  torch.from_numpy(center),
                                  torch.from_numpy(scale), (48, 64)).numpy()
    want = np.asarray(JT.transform_preds_jax(
        jnp.asarray(coords), jnp.asarray(center), jnp.asarray(scale),
        (48, 64)))
    np.testing.assert_allclose(got, want, atol=ATOL_PX, rtol=0)
    # host f64 solve: the f32 device form agrees to f32 resolution at
    # pixel coordinates up to ~1000
    host = np.stack([T.transform_preds(coords[i], center[i], scale[i],
                                       (48, 64)) for i in range(6)])
    np.testing.assert_allclose(got, host, atol=2e-4, rtol=0)
    for rot in (0.0, 30.0):
        np.testing.assert_array_equal(
            T.get_affine_transform(center[0], scale[0], rot, (192, 256)),
            JT.get_affine_transform(center[0], scale[0], rot, (192, 256)))


def test_get_final_preds_matches_jax():
    hm = heatmaps(4)
    rng = np.random.RandomState(5)
    center = rng.uniform(100, 400, (4, 2)).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, (4, 2)).astype(np.float32)
    p, m = H.get_final_preds(nchw(hm), torch.from_numpy(center),
                             torch.from_numpy(scale))
    jp, jm = JH.get_final_preds(jnp.asarray(hm), jnp.asarray(center),
                                jnp.asarray(scale))
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), atol=ATOL_PX,
                               rtol=0)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))


def test_pck_matches_jax():
    rng = np.random.RandomState(6)
    out = rng.rand(4, 16, 12, 17).astype(np.float32)
    joints = rng.uniform(0, 48, (4, 17, 2)).astype(np.float32)
    tgt = np.asarray(JH.generate_target(jnp.asarray(joints),
                                        jnp.ones((4, 17)), (48, 64),
                                        (12, 16), 2)[0])
    mask = np.array([1, 1, 1, 0], np.float32)
    hit, val = H.pck_sums(nchw(out), nchw(tgt), sample_mask=torch.from_numpy(
        mask))
    jhit, jval = JH.pck_sums(jnp.asarray(out), jnp.asarray(tgt),
                             sample_mask=jnp.asarray(mask))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    np.testing.assert_array_equal(val.numpy(), np.asarray(jval))
    for a, b in zip(H.pck_from_sums(hit, val), JH.pck_from_sums(jhit, jval)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("kind", ["smooth_l1", "mse", "ohkm"])
@pytest.mark.parametrize("use_tw", [True, False])
def test_per_sample_losses_match_jax(kind, use_tw):
    rng = np.random.RandomState(7)
    out = (rng.randn(3, 16, 12, 17) * 2).astype(np.float32)
    tgt = rng.rand(3, 16, 12, 17).astype(np.float32)
    tw = (rng.rand(3, 17) > 0.3).astype(np.float32)
    args = (nchw(out), nchw(tgt), torch.from_numpy(tw), use_tw)
    jargs = (jnp.asarray(out), jnp.asarray(tgt), jnp.asarray(tw), use_tw)
    if kind == "ohkm":
        got = L.joints_ohkm_loss_per_sample(*args, topk=8)
        want = JL.joints_ohkm_loss_per_sample(*jargs, topk=8)
    else:
        got = L.joints_loss_per_sample(*args, criterion=kind)
        want = JL.joints_loss_per_sample(*jargs, criterion=kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
