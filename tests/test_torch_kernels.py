"""The plain PyTorch versions of the port's CUDA kernels against the
JAX package's Pallas kernels (run in interpret mode on the CPU, as the
JAX package's own tests run them), and the keep lists of the OKS-NMS
routes against the numpy oracle. The CUDA kernels themselves are held to
their plain versions on a card by tests/test_torch_gpu.py.

Tolerances: decode is exact (the same comparisons and the same f32 adds
of 0.25). OKS: rtol 1e-5, atol 1e-6, since XLA's and torch's `exp`
differ in the last bits. Keep lists: equal.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from advmix_tpu.ops import heatmap as JH
from advmix_tpu.ops import nms as JN
from advmix_tpu.ops.pallas.decode_kernel import decode_heatmaps_pallas
from advmix_tpu.ops.pallas.oks_kernel import (oks_matrix_batched_pallas,
                                              oks_matrix_pallas)
from advmix_tpu_torch import native
from advmix_tpu_torch.evaluation.coco_eval import (_oks_matrices_batched,
                                                   _oks_nms_device)
from advmix_tpu_torch.ops import nms as N
from advmix_tpu_torch.ops.cuda.decode_kernel import (decode_heatmaps,
                                                     decode_heatmaps_plain)
from advmix_tpu_torch.ops.cuda.oks_kernel import (oks_matrix,
                                                  oks_matrix_batched)


def crafted_heatmaps(seed, b=3, j=17, h=16, w=12):
    """NHWC maps: random, exact ties (one pair in a later row and an
    earlier column), all-zero, negative, -inf, and peaks on and next to
    every border."""
    rng = np.random.RandomState(seed)
    hm = rng.rand(b, h, w, j).astype(np.float32)
    hm[0, :, :, 0] = 0.0
    hm[0, :, :, 1] = -1.0 - hm[0, :, :, 1]
    hm[0, :, :, 2] = np.round(hm[0, :, :, 2] * 3) / 3
    hm[0, :, :, 3] = 0.5 * hm[0, :, :, 3]
    hm[0, 2, 9, 3] = 2.0
    hm[0, 7, 3, 3] = 2.0
    hm[0, :, :, 4] = -np.inf
    k = 0
    for py in (0, 1, h - 2, h - 1):
        for px in (0, 1, w - 2, w - 1):
            m = 1 + k // j
            hm[m, :, :, k % j] = rng.rand(h, w)
            hm[m, py, px, k % j] = 5.0
            k += 1
    return hm


@pytest.mark.parametrize("post_process", [True, False])
def test_plain_decode_matches_pallas(post_process):
    hm = crafted_heatmaps(0)
    want_c, want_m = decode_heatmaps_pallas(jnp.asarray(hm), post_process,
                                            interpret=True)
    before = decode_heatmaps.launches
    got_c, got_m = decode_heatmaps(
        torch.from_numpy(np.ascontiguousarray(hm.transpose(0, 3, 1, 2))),
        post_process)
    assert decode_heatmaps.launches == before  # CPU: the plain version
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    # the tie went to the row-major first peak, (x=9, y=2), not (3, 7)
    assert np.abs(got_c[0, 3].numpy() - [9.0, 2.0]).max() <= 0.25


def test_plain_decode_matches_xla_path():
    """get_max_preds + quarter_offset, as the JAX step runs them off the
    TPU. That path masks coords before the offset and the kernel after;
    both agree because a masked peak sits at (0, 0), never inside."""
    hm = crafted_heatmaps(1)
    hm[:, :, :, 4] = -1.0  # XLA's path gives NaN offsets on -inf maps
    jc, jm = JH.get_max_preds(jnp.asarray(hm))
    jc = JH.quarter_offset(jnp.asarray(hm), jc)
    got_c, got_m = decode_heatmaps_plain(
        torch.from_numpy(np.ascontiguousarray(hm.transpose(0, 3, 1, 2))))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(jm))


def _dets(rng, m, p, j=17):
    base = rng.uniform(50, 150, (m, 1, j, 2))
    kpts = base + rng.randn(m, p, j, 2) * rng.uniform(1, 30, (m, p, 1, 1))
    return (kpts.astype(np.float32), rng.uniform(0.1, 1.0, (m, p)),
            rng.uniform(1000, 9000, (m, p)).astype(np.float32))


@pytest.mark.parametrize("p", [2, 16, 128])
def test_plain_oks_batched_matches_pallas(p):
    kpts, _, areas = _dets(np.random.RandomState(p), 3, p)
    want = oks_matrix_batched_pallas(jnp.asarray(kpts), jnp.asarray(areas),
                                     interpret=True)
    got = oks_matrix_batched(torch.from_numpy(kpts), torch.from_numpy(areas))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("n", [37, 130])
def test_plain_oks_single_matches_pallas(n):
    """N=130 crosses the Pallas kernel's 128-wide tile edge."""
    kpts, _, areas = _dets(np.random.RandomState(n), 1, n)
    want = oks_matrix_pallas(jnp.asarray(kpts[0]), jnp.asarray(areas[0]),
                             interpret=True)
    got = oks_matrix(torch.from_numpy(kpts[0]), torch.from_numpy(areas[0]))
    assert got.shape == (n, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def _flat(kpts, rng):
    vis = rng.uniform(0, 1, kpts.shape[:-1] + (1,))
    return np.concatenate([kpts, vis], -1).reshape(len(kpts), -1).astype(
        np.float64)


def test_single_image_route_keep_list():
    """coco_eval's single-image route (OKS matrix + greedy scan) gives the
    reference keep list (the pattern of tests/test_native_pallas.py)."""
    rng = np.random.RandomState(11)
    kpts, scores, areas = _dets(rng, 1, 130)
    flat = _flat(kpts[0], rng)
    want = JN.oks_nms_np(flat, scores[0], areas[0].astype(np.float64), 0.9)
    assert N.oks_nms_np(flat, scores[0], areas[0].astype(np.float64),
                        0.9) == want
    assert _oks_nms_device(flat, scores[0], areas[0].astype(np.float64), 0.9,
                           torch.device("cpu")) == want


def test_batched_route_keep_lists():
    rng = np.random.RandomState(7)
    cand, raw = [], {}
    for m in range(20):
        n = rng.randint(2, 21)
        kpts, scores, areas = _dets(rng, 1, n)
        flat = _flat(kpts[0], rng)
        cand.append((1000 + m, [
            {"keypoints": flat[i].reshape(17, 3), "area": float(areas[0, i]),
             "score": float(scores[0, i])} for i in range(n)]))
        raw[1000 + m] = (flat, scores[0], areas[0].astype(np.float64))
    sims = _oks_matrices_batched(cand, 17, torch.device("cpu"))
    assert set(sims) == set(raw)
    for iid, (flat, scores, areas) in raw.items():
        want = JN.oks_nms_np(flat, scores, areas, 0.9)
        assert native.greedy_from_matrix(
            sims[iid], scores.astype(np.float32), 0.9) == want, iid


@pytest.mark.parametrize("thr", [0.3, 0.5, 0.9])
def test_native_nms_matches_oracles(thr):
    rng = np.random.RandomState(2)
    kpts, scores, areas = _dets(rng, 1, 30)
    flat = _flat(kpts[0], rng)
    a = areas[0].astype(np.float64)
    assert native.get_lib() is not None
    assert native.oks_nms(flat, scores[0], a, thr) == \
        JN.oks_nms_np(flat, scores[0], a, thr)
    assert native.soft_oks_nms(flat, scores[0], a, thr) == \
        JN.soft_oks_nms_np(flat, scores[0], a, thr)


def test_wrappers_raise_off_cpu_and_cuda():
    """A tensor that is neither on the CPU nor on a card is refused, not
    decoded by the plain version."""
    with pytest.raises(ValueError):
        decode_heatmaps(torch.empty(1, 1, 4, 4, device="meta"))
    with pytest.raises(ValueError):
        oks_matrix(torch.empty(3, 17, 2, device="meta"),
                   torch.empty(3, device="meta"))
