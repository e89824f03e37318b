"""The port's bottom-up data path against the JAX package's: the ignore
masks (`data/masks.py`: compressed and uncompressed RLE, polygons, the
valid mask, the per-image ignore segmentations) and `BottomUpCOCODataset`
(train and eval samples from the same `RandomState`, on a tiny COCO tree
with crowd RLEs and zero-keypoint people; the `ochuman` alias; the
loader's collate).

Both packages run the same numpy and cv2 code on the same files, so every
comparison is exact: masks, images and visibilities equal, joints, centers
and scales equal to the bit.
"""

import json
import os

import cv2
import numpy as np
import pytest

from advmix_tpu.config import load_config as jax_load_config
from advmix_tpu.data import build_dataset as jax_build_dataset
from advmix_tpu.data import masks as jax_masks
from advmix_tpu_torch.config import load_config
from advmix_tpu_torch.data import Loader, build_dataset
from advmix_tpu_torch.data import masks
from advmix_tpu_torch.data.bottomup import MAX_PEOPLE, BottomUpCOCODataset

from test_bottomup_mask import _mask_to_counts, _rle_to_string

J = 17


def _kps(rng, w, h, n_vis):
    """A COCO keypoint list with `n_vis` labelled joints (v 1 or 2)."""
    kps = np.zeros((J, 3))
    on = rng.permutation(J)[:n_vis]
    kps[on, 0] = rng.uniform(2, w - 2, n_vis)
    kps[on, 1] = rng.uniform(2, h - 2, n_vis)
    kps[on, 2] = rng.choice([1, 2], n_vis)
    return [float(v) for v in kps.reshape(-1)]


def write_bottomup_coco(root: str, image_set: str, sizes, rng,
                        people=(1, 3), pixels=None) -> dict:
    """A COCO-format tree `root/{annotations,<image_set>}` of JPEGs with
    COCO file names: per image `people` annotated persons, one crowd region
    as a compressed RLE string, one zero-keypoint person as a polygon, and
    (every other image) an uncompressed-RLE crowd. `pixels(i, h, w)` gives
    image i's uint8 pixels (default: seeded noise). Returns the json."""
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    os.makedirs(os.path.join(root, image_set), exist_ok=True)
    images, anns = [], []
    for i, (w, h) in enumerate(sizes, start=1):
        img = (pixels(i, h, w) if pixels is not None
               else rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
        cv2.imwrite(os.path.join(root, image_set, "%012d.jpg" % i), img)
        images.append(dict(id=i, width=w, height=h,
                           file_name="%012d.jpg" % i))
        for _ in range(rng.randint(people[0], people[1] + 1)):
            x0, y0 = rng.uniform(0, w / 3), rng.uniform(0, h / 3)
            bw, bh = rng.uniform(w / 4, w / 2), rng.uniform(h / 4, h / 2)
            anns.append(dict(image_id=i, category_id=1, iscrowd=0,
                             keypoints=_kps(rng, w, h, rng.randint(3, J + 1)),
                             bbox=[x0, y0, bw, bh], area=bw * bh,
                             segmentation=[[x0, y0, x0 + bw, y0, x0 + bw,
                                            y0 + bh, x0, y0 + bh]]))
        crowd = np.zeros((h, w), np.uint8)
        cy, cx = rng.randint(0, h // 2), rng.randint(0, w // 2)
        crowd[cy:cy + h // 3, cx:cx + w // 4] = 1
        anns.append(dict(image_id=i, category_id=1, iscrowd=1, keypoints=[],
                         num_keypoints=0, bbox=[cx, cy, w // 4, h // 3],
                         area=float(crowd.sum()),
                         segmentation={"counts": _rle_to_string(
                             _mask_to_counts(crowd)), "size": [h, w]}))
        px, py = rng.uniform(w / 2, w - 20), rng.uniform(h / 2, h - 20)
        anns.append(dict(image_id=i, category_id=1, iscrowd=0,
                         keypoints=[0.0] * (3 * J), num_keypoints=0,
                         bbox=[px, py, 15, 15], area=150.0,
                         segmentation=[[px, py, px + 15, py, px + 8,
                                        py + 15]]))
        if i % 2 == 0:
            crowd2 = np.zeros((h, w), np.uint8)
            crowd2[h - 12:, :10] = 1
            anns.append(dict(image_id=i, category_id=1, iscrowd=1,
                             keypoints=[], num_keypoints=0,
                             bbox=[0, h - 12, 10, 12], area=120.0,
                             segmentation={"counts": _mask_to_counts(crowd2),
                                           "size": [h, w]}))
    for k, a in enumerate(anns, start=1):
        a["id"] = k
        a.setdefault("num_keypoints",
                     int(np.count_nonzero(np.asarray(a["keypoints"])[2::3])))
    coco = dict(images=images, annotations=anns,
                categories=[dict(id=1, name="person")])
    with open(os.path.join(root, "annotations",
                           f"person_keypoints_{image_set}.json"), "w") as f:
        json.dump(coco, f)
    return coco


def bottomup_cfgs(root: str, size: int = 64, dataset: str = "bottomup_coco"):
    """The same frozen config in both packages."""
    out = []
    for load in (load_config, jax_load_config):
        cfg = load()
        cfg.defrost()
        cfg.DATASET.DATASET = dataset
        cfg.DATASET.ROOT = root
        cfg.DATASET.TRAIN_SET = "train2017"
        cfg.DATASET.TEST_SET = "val2017"
        cfg.DATASET.COLOR_RGB = True
        cfg.MODEL.NAME = "pose_higher_hrnet"
        cfg.MODEL.IMAGE_SIZE = [size, size]
        cfg.MODEL.HEATMAP_SIZE = [size // 4, size // 4]
        cfg.freeze()
        out.append(cfg)
    return out


SIZES = [(96, 80), (64, 120), (128, 96), (100, 100)]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bucoco"))
    rng = np.random.RandomState(0)
    coco = {s: write_bottomup_coco(root, s, SIZES, rng)
            for s in ("train2017", "val2017")}
    return root, coco


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------

def test_rle_string_decode_matches_jax():
    rng = np.random.RandomState(1)
    for _ in range(5):
        m = (rng.rand(23, 17) > 0.6).astype(np.uint8)
        s = _rle_to_string(_mask_to_counts(m))
        assert masks.rle_string_to_counts(s) == \
            jax_masks.rle_string_to_counts(s)
        np.testing.assert_array_equal(masks.rle_decode(s, 23, 17), m)


@pytest.mark.parametrize("form", ["rle_counts", "rle_string", "polygon",
                                  "rle_other_size", "rle_truncated"])
def test_seg_to_mask_matches_jax(form):
    rng = np.random.RandomState(2)
    h, w = 30, 40
    m = (rng.rand(h, w) > 0.5).astype(np.uint8)
    seg = {
        "rle_counts": {"counts": _mask_to_counts(m), "size": [h, w]},
        "rle_string": {"counts": _rle_to_string(_mask_to_counts(m)),
                       "size": [h, w]},
        "polygon": [[3.2, 4.0, 30.5, 6.1, 22.0, 25.7, 5.0, 20.0],
                    [1, 1, 2, 2], [35, 2, 39, 2, 39, 9]],
        "rle_other_size": {"counts": _mask_to_counts(m[:15, :20]),
                           "size": [15, 20]},
        "rle_truncated": {"counts": _mask_to_counts(m)[:-3],
                          "size": [h, w]},
    }[form]
    got = masks.seg_to_mask(seg, h, w)
    assert got.shape == (h, w) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jax_masks.seg_to_mask(seg, h, w))


def test_valid_mask_and_ignore_segs_match_jax(tree):
    root, coco = tree
    ann = os.path.join(root, "annotations", "person_keypoints_val2017.json")
    got = masks.load_coco_ignore_segs(ann)
    want = jax_masks.load_coco_ignore_segs(ann, max_images=None, coco=coco[
        "val2017"])
    assert got.keys() == want.keys() and len(got) == len(SIZES)
    for iid, info in got.items():
        assert info["hw"] == want[iid]["hw"]
        assert info["segs"] == want[iid]["segs"] and info["segs"]
        h, w = info["hw"]
        valid = masks.build_valid_mask(info["segs"], h, w)
        assert valid.dtype == np.float32 and 0 < valid.mean() < 1
        np.testing.assert_array_equal(
            valid, jax_masks.build_valid_mask(info["segs"], h, w))
    assert masks.build_valid_mask([], 4, 5).min() == 1.0


# ---------------------------------------------------------------------------
# BottomUpCOCODataset
# ---------------------------------------------------------------------------

def _assert_same_sample(got, want):
    assert set(got) == set(want), (set(got) ^ set(want))
    for k, v in want.items():
        if isinstance(v, np.ndarray) or np.isscalar(v) and not isinstance(
                v, str):
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v),
                                          err_msg=k)
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("is_train", [True, False])
def test_samples_match_jax(tree, is_train):
    root, _ = tree
    cfg, jcfg = bottomup_cfgs(root)
    ds = build_dataset(cfg, is_train=is_train)
    jds = jax_build_dataset(jcfg, is_train=is_train)
    assert isinstance(ds, BottomUpCOCODataset) and len(ds) == len(jds) == 4
    rotations = []
    for idx in range(len(ds)):
        for seed in (0, 1, 2):
            got = ds.get_sample(idx, np.random.RandomState(seed))
            want = jds.get_sample(idx, np.random.RandomState(seed))
            _assert_same_sample(got, want)
            assert got["joints"].shape == (MAX_PEOPLE, J, 2)
            assert ("mask" in got) == is_train
            if is_train:
                assert got["mask"].shape == (64, 64)
                assert 0 < got["mask"].mean() < 1  # a real ignore region
            rotations.append(float(got["rotation"]))
    # the train draws really augment; eval draws nothing
    assert any(rotations) == is_train
    assert ds.image_set == ("train2017" if is_train else "val2017")


def test_loader_collates_joints_and_mask(tree):
    root, _ = tree
    cfg, _ = bottomup_cfgs(root)
    batch = next(iter(Loader(build_dataset(cfg, is_train=True), 3,
                             num_threads=1)))
    assert batch["joints"].shape == (3, MAX_PEOPLE, J, 2)
    assert batch["joints_vis"].shape == (3, MAX_PEOPLE, J)
    assert batch["mask"].shape == (3, 64, 64)
    assert batch["image"].shape == (3, 64, 64, 3)
    eval_batch = next(iter(Loader(build_dataset(cfg, is_train=False), 3,
                                  num_threads=1)))
    assert "mask" not in eval_batch


def test_ochuman_alias(tree):
    """OCHuman ships COCO-format json: `ochuman` is the same loader."""
    root, _ = tree
    cfg, jcfg = bottomup_cfgs(root, dataset="ochuman")
    ds = build_dataset(cfg, is_train=False)
    assert isinstance(ds, BottomUpCOCODataset)
    _assert_same_sample(ds.get_sample(1, np.random.RandomState(0)),
                        jax_build_dataset(jcfg, is_train=False).get_sample(
                            1, np.random.RandomState(0)))
