"""The port's training data path against the JAX package's: the on-device
warp, `fliplr_joints`, the train branch of `get_sample` and
`get_raw_sample`, COCO train records with `select_data`, and the Loader's
order under `shuffle`, `set_epoch` and `drop_last`.

Tolerances: the host path is exact (both packages draw from the same numpy
stream in the same order and call the same cv2 and numpy functions).
`warp_affine` is held to 1e-3 of a uint8 level: both sides compute the
source coordinates and the bilinear blend in f32, but XLA may contract the
coordinate's multiply-adds, which moves a blend weight by an f32 epsilon of
a coordinate up to 640.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advmix_tpu.config import load_config as jax_load_config
from advmix_tpu.data import Loader as JaxLoader
from advmix_tpu.data import build_dataset as jax_build_dataset
from advmix_tpu.data.datasets import _compose_mirror as jax_compose_mirror
from advmix_tpu.ops import transforms as JT
from advmix_tpu_torch.config import load_config
from advmix_tpu_torch.data import CachedLoader, Loader, build_dataset
from advmix_tpu_torch.data.datasets import _compose_mirror
from advmix_tpu_torch.ops import transforms as TT

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "experiments/synthetic/res18_64x64_smoke.yaml")
KEYS = ("image", "joints", "joints_vis", "center", "scale", "rotation",
        "score")


def _datasets(length, is_train=True, **dataset_opts):
    out = []
    for load, build in ((jax_load_config, jax_build_dataset),
                        (load_config, build_dataset)):
        cfg = load()
        cfg.defrost()
        cfg.merge_from_file(SMOKE)
        cfg.DATASET.SYNTH_LENGTH = length
        cfg.DATASET.PROB_HALF_BODY = 0.5
        cfg.DATASET.NUM_JOINTS_HALF_BODY = 3
        for k, v in dataset_opts.items():
            cfg.DATASET[k] = v
        cfg.freeze()
        out.append(build(cfg, is_train=is_train))
    return out


def _crop_matrices(rng, n, size):
    """Crop matrices as `get_raw_sample` makes them: random center, scale
    and rotation, every other one with the flip folded in."""
    mats = []
    for i in range(n):
        c = rng.uniform(60, 200, 2).astype(np.float32)
        s = (rng.uniform(0.4, 1.6) * np.ones(2)).astype(np.float32)
        m = TT.get_affine_transform(c, s, rng.uniform(-60, 60), size)
        mats.append(_compose_mirror(m, 300) if i % 2 else m)
    return np.stack(mats).astype(np.float32)


def test_warp_affine_matches_jax():
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (6, 260, 300, 3)).astype(np.uint8)
    mats = _crop_matrices(rng, 6, (48, 64))
    want = np.asarray(JT.warp_affine(jnp.asarray(img, jnp.float32),
                                     jnp.asarray(mats), (48, 64)))
    got = TT.warp_affine(torch.from_numpy(img), torch.from_numpy(mats),
                         (48, 64))
    assert got.shape == (6, 64, 48, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)
    assert (want == 0).any() and want.max() > 200  # borders and content
    # a float image warps like its uint8 original
    got_f = TT.warp_affine(torch.from_numpy(img).float(),
                           torch.from_numpy(mats), (48, 64))
    assert torch.equal(got_f, got)
    np.testing.assert_allclose(
        TT.invert_affine(torch.from_numpy(mats)).numpy(),
        np.asarray(JT.invert_affine(jnp.asarray(mats))), rtol=1e-6,
        atol=1e-6)


def test_warp_affine_identity_and_integer_shift():
    img = np.random.RandomState(1).randint(0, 256, (1, 20, 30, 3)).astype(
        np.uint8)
    eye = torch.tensor([[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]])
    got = TT.warp_affine(torch.from_numpy(img), eye, (30, 20))
    np.testing.assert_array_equal(got.numpy(), img.astype(np.float32))
    shift = torch.tensor([[[1.0, 0.0, 4.0], [0.0, 1.0, -3.0]]])
    got = TT.warp_affine(torch.from_numpy(img), shift, (30, 20)).numpy()
    np.testing.assert_array_equal(got[0, :17, 4:], img[0, 3:, :26])
    assert (got[0, :, :4] == 0).all() and (got[0, 17:] == 0).all()


def test_fliplr_joints_and_compose_mirror():
    rng = np.random.RandomState(2)
    joints = rng.uniform(0, 100, (8, 3))
    vis = (rng.rand(8, 3) > 0.3).astype(np.float64)
    pairs = [[0, 1], [2, 3], [6, 7]]
    gj, gv = TT.fliplr_joints(joints, vis, 120, pairs)
    wj, wv = JT.fliplr_joints(joints, vis, 120, pairs)
    np.testing.assert_array_equal(gj, wj)
    np.testing.assert_array_equal(gv, wv)
    m = rng.randn(2, 3)
    np.testing.assert_array_equal(_compose_mirror(m, 77),
                                  jax_compose_mirror(m, 77))


@pytest.mark.parametrize("raw", [False, True], ids=["get_sample",
                                                    "get_raw_sample"])
def test_train_samples_bit_identical_to_jax(raw):
    jds, ds = _datasets(12)
    assert ds.upper_body_ids == jds.upper_body_ids
    flips = rots = halves = 0
    for idx in range(12):
        for seed in (idx, 1000 + idx):
            if raw:
                want = jds.get_raw_sample(idx, np.random.RandomState(seed),
                                          (320, 288))
                got = ds.get_raw_sample(idx, np.random.RandomState(seed),
                                        (320, 288))
                np.testing.assert_array_equal(got["warp_matrix"],
                                              want["warp_matrix"])
                assert got["image"].shape == (320, 288, 3)
                flips += want["warp_matrix"][0, 0] < 0
            else:
                want = jds.get_sample(idx, np.random.RandomState(seed))
                got = ds.get_sample(idx, np.random.RandomState(seed))
            for k in KEYS:
                assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got["image_path"] == want["image_path"]
            rots += want["rotation"] != 0
            halves += want["center"][1] != 140.0
    # the draws took every branch: rotation, half-body (a center off the
    # record's own), and on the raw path the folded flip
    assert 0 < rots < 24 and halves > 0
    if raw:
        assert 0 < flips < 24


def test_raw_sample_warps_to_the_host_crop():
    """The two sample paths agree: the raw bucket warped on the device by
    its crop matrix is the host's cv2 crop, up to cv2's fixed-point
    interpolation (1/32 px coordinates: a few uint8 levels at edges)."""
    _, ds = _datasets(6)
    for idx in range(6):
        host = ds.get_sample(idx, np.random.RandomState(idx))
        raw = ds.get_raw_sample(idx, np.random.RandomState(idx), (280, 280))
        for k in ("joints", "joints_vis", "center", "scale"):
            np.testing.assert_array_equal(raw[k], host[k])
        warped = TT.warp_affine(torch.from_numpy(raw["image"][None]),
                                torch.from_numpy(raw["warp_matrix"][None]),
                                (64, 64))[0].numpy()
        diff = np.abs(warped - host["image"].astype(np.float32))
        assert np.mean(diff) < 2.0, np.mean(diff)


def test_raw_sample_truncates_to_a_small_bucket(caplog):
    _, ds = _datasets(2)
    with caplog.at_level("WARNING", logger="advmix_tpu_torch"):
        ds.get_raw_sample(0, np.random.RandomState(0), (100, 120))
    s = ds.get_raw_sample(1, np.random.RandomState(0), (300, 400))
    assert s["image"].shape == (300, 400, 3)
    assert (s["image"][280:] == 0).all() and (s["image"][:, 280:] == 0).all()


def _order(loader):
    return [b["_indices"].tolist() for b in loader]


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (True, False),
                                               (False, True)])
def test_loader_order_matches_jax(shuffle, drop_last):
    jds, ds = _datasets(11, is_train=False)
    jl = JaxLoader(jds, 4, shuffle=shuffle, drop_last=drop_last, seed=3)
    tl = Loader(ds, 4, shuffle=shuffle, drop_last=drop_last, seed=3)
    assert len(tl) == len(jl) == (2 if drop_last else 3)
    seen = []
    for epoch in (0, 1, 5):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        assert _order(tl) == _order(jl)
        seen.append(_order(tl))
    assert (seen[0] != seen[1]) == shuffle
    if not drop_last:
        last = list(tl)[-1]
        assert last["_n"] == 3 and last["_indices"][-1] == last["_indices"][-2]


@pytest.mark.parametrize("raw_mode", [False, True])
def test_train_loader_batches_bit_identical_to_jax(raw_mode):
    """Per-sample seeding: sample i of epoch e draws from
    RandomState((seed * 100003 + e + i) % 2**31) in both packages."""
    jds, ds = _datasets(9)
    kw = dict(shuffle=True, drop_last=True, seed=2, raw_mode=raw_mode,
              bucket_hw=(288, 320))
    jl, tl = JaxLoader(jds, 4, **kw), Loader(ds, 4, **kw)
    for epoch in (0, 3):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        got, want = list(tl), list(jl)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            for k in KEYS + (("warp_matrix",) if raw_mode else ()):
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    single = list(Loader(ds, 4, num_threads=1, **kw))
    tl.set_epoch(0)
    for g, s in zip(tl, single):
        np.testing.assert_array_equal(g["image"], s["image"])


def test_cached_loader_replays_and_refuses_shuffle():
    _, ds = _datasets(6, is_train=False)
    cached = CachedLoader(Loader(ds, 4))
    first = [b["image"].copy() for b in cached]
    calls = []
    ds.get_sample = lambda *a, **k: calls.append(a)  # must not be reached
    again = list(cached)
    assert not calls and len(again) == len(cached) == 2
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b["image"])
    again[0]["extra"] = 1
    assert "extra" not in next(iter(cached))
    with pytest.raises(ValueError):
        CachedLoader(Loader(ds, 4, shuffle=True))
    small = CachedLoader(Loader(build_dataset(ds.cfg, False), 4),
                         max_bytes=10)
    assert len(list(small)) == 2 and small._cache is None


def _coco_train_json(root):
    os.makedirs(os.path.join(root, "annotations"))
    rng = np.random.RandomState(0)
    images, anns = [], []
    for i in range(1, 7):
        images.append(dict(id=i, width=640, height=480,
                           file_name="%012d.jpg" % i))
        for _ in range(3):
            cx, cy = rng.uniform(150, 500), rng.uniform(150, 330)
            n_vis = rng.randint(1, 18)
            kps = []
            for j in range(17):
                spread = 200 if rng.rand() < 0.3 else 40
                kps += [float(cx + rng.uniform(-spread, spread)),
                        float(cy + rng.uniform(-60, 60)),
                        2 if j < n_vis else 0]
            xs, ys = kps[0::3], kps[1::3]
            x0, y0 = cx - 60, cy - 80
            anns.append(dict(id=len(anns) + 1, image_id=i, category_id=1,
                             keypoints=kps, num_keypoints=int(n_vis),
                             bbox=[x0, y0, 120.0, 160.0], area=120.0 * 160.0,
                             iscrowd=0))
    with open(os.path.join(root, "annotations",
                           "person_keypoints_train2017.json"), "w") as f:
        json.dump(dict(images=images, annotations=anns,
                       categories=[dict(id=1, name="person")]), f)


@pytest.mark.parametrize("select", [False, True])
def test_coco_train_records_match_jax(tmp_path, select):
    _coco_train_json(str(tmp_path))
    both = []
    for load, build in ((jax_load_config, jax_build_dataset),
                        (load_config, build_dataset)):
        cfg = load()
        cfg.defrost()
        cfg.DATASET.DATASET = "coco"
        cfg.DATASET.ROOT = str(tmp_path)
        cfg.DATASET.TRAIN_SET = "train2017"
        cfg.DATASET.SELECT_DATA = select
        cfg.MODEL.IMAGE_SIZE = [192, 256]
        cfg.MODEL.NUM_JOINTS = 17
        cfg.TEST.USE_GT_BBOX = False  # training reads ground truth anyway
        cfg.freeze()
        both.append(build(cfg, is_train=True))
    jds, ds = both
    assert ds.image_set == "train2017"
    assert len(ds) == len(jds) > 0
    assert (len(ds) < 18) == select
    for got, want in zip(ds.records, jds.records):
        assert got["image"] == want["image"]
        for k in ("center", "scale", "joints_3d", "joints_3d_vis"):
            np.testing.assert_array_equal(got[k], want[k])
