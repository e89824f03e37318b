"""Datasets: host-side records and the per-sample crop, eval and train.

Port of `advmix_tpu/data/datasets.py` (reference
`lib/dataset/JointsDataset.py`, `lib/dataset/coco.py:70-83`,
`lib/dataset/mpii.py:36-41`), and of its `ConcatDataset` for
--stylize_image (`tools/train.py:145-163`); the bottom-up dataset is in
`data/bottomup.py`. For the top-down datasets the host
decodes the image, draws the augmentation parameters of a training sample
(half-body, scale, rotation, flip, in that order from one numpy stream) and
either warps a fixed-size uint8 crop with cv2 (`get_sample`) or hands on
the image padded into a static bucket with its 2x3 crop matrix
(`get_raw_sample`), so that the warp runs batched on the device
(`ops/transforms.warp_affine`). Everything after (normalization, the AdvMix
views, targets) runs on the device. `cv2` is imported where a JPEG is
decoded or a crop warped, so importing the package does not need it, and
`get_raw_sample` on an image that is already decoded never does. With
DATASET.DATA_FORMAT `zip` the images are members of `<set>.zip`
(`utils/zipreader.py`).
"""

from __future__ import annotations

import logging
import os
from collections import OrderedDict
from typing import List, Optional

import numpy as np

from ..ops.transforms import PIXEL_STD, affine_transform, fliplr_joints, \
    get_affine_transform
from ..utils.logging import LOGGER_NAME
from . import records as records_lib


def _compose_mirror(trans: np.ndarray, width: int) -> np.ndarray:
    """Fold a horizontal flip of the source image into a 2x3 affine: the
    result maps original coordinates as `trans` maps flipped ones
    (x_flipped = width - 1 - x)."""
    mirror = np.array([[-1.0, 0.0, width - 1.0], [0.0, 1.0, 0.0]])
    m3 = np.vstack([mirror, [0.0, 0.0, 1.0]])
    return trans @ m3


class BaseJointsDataset:
    num_joints: int = 0
    flip_pairs: List[List[int]] = []
    parent_ids = None
    upper_body_ids = ()
    lower_body_ids = ()

    def __init__(self, cfg, is_train: bool):
        self.cfg = cfg
        self.is_train = is_train
        self.image_size = np.array(cfg.MODEL.IMAGE_SIZE)  # (w, h)
        self.heatmap_size = np.array(cfg.MODEL.HEATMAP_SIZE)
        self.scale_factor = cfg.DATASET.SCALE_FACTOR
        self.rotation_factor = cfg.DATASET.ROT_FACTOR
        self.flip = cfg.DATASET.FLIP
        self.num_joints_half_body = cfg.DATASET.NUM_JOINTS_HALF_BODY
        self.prob_half_body = cfg.DATASET.PROB_HALF_BODY
        self.color_rgb = cfg.DATASET.COLOR_RGB
        self.aspect_ratio = self.image_size[0] / self.image_size[1]
        self.records: List[dict] = []

    def __len__(self):
        return len(self.records)

    def half_body_transform(self, joints, joints_vis, rng):
        """`lib/dataset/JointsDataset.py:69-111`: a box around the visible
        upper- or lower-body joints."""
        upper, lower = [], []
        for j in range(self.num_joints):
            if joints_vis[j][0] > 0:
                (upper if j in self.upper_body_ids else lower).append(joints[j])
        if rng.randn() < 0.5 and len(upper) > 2:
            selected = upper
        else:
            selected = lower if len(lower) > 2 else upper
        if len(selected) < 2:
            return None, None
        selected = np.array(selected, dtype=np.float32)
        center = selected.mean(axis=0)[:2]
        lt = selected.min(axis=0)
        rb = selected.max(axis=0)
        w, h = rb[0] - lt[0], rb[1] - lt[1]
        if w > self.aspect_ratio * h:
            h = w / self.aspect_ratio
        elif w < self.aspect_ratio * h:
            w = h * self.aspect_ratio
        scale = np.array([w / PIXEL_STD, h / PIXEL_STD], np.float32) * 1.5
        return center, scale

    def _draw_augmentation(self, joints, joints_vis, c, s, width: int, rng):
        """The train branch's draws, in the reference's order
        (`JointsDataset.py:167-188`): half-body, scale, rotation, flip.
        Returns (joints, joints_vis, c, s, r, flipped); a flip mirrors the
        joints and the center, the caller mirrors the pixels."""
        if (np.sum(joints_vis[:, 0]) > self.num_joints_half_body
                and rng.rand() < self.prob_half_body):
            c_hb, s_hb = self.half_body_transform(joints, joints_vis, rng)
            if c_hb is not None:
                c, s = c_hb, s_hb
        sf, rf = self.scale_factor, self.rotation_factor
        s = s * np.clip(rng.randn() * sf + 1, 1 - sf, 1 + sf)
        r = (float(np.clip(rng.randn() * rf, -rf * 2, rf * 2))
             if rng.rand() <= 0.6 else 0.0)
        flipped = bool(self.flip and rng.rand() <= 0.5)
        if flipped:
            joints, joints_vis = fliplr_joints(joints, joints_vis, width,
                                               self.flip_pairs)
            c[0] = width - c[0] - 1
        return joints, joints_vis, c, s, r, flipped

    def _read_image(self, path: str) -> np.ndarray:
        import cv2

        flags = cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION
        if self.cfg.DATASET.DATA_FORMAT == "zip":
            from ..utils import zipreader

            img = zipreader.imread(path, flags)
        else:
            img = cv2.imread(path, flags)
        if img is None:
            raise ValueError(f"Fail to read {path}")
        if self.color_rgb:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        return img

    def get_sample(self, idx: int, rng: np.random.RandomState) -> dict:
        """Decode, draw the augmentation (training only; the eval branch
        draws nothing from `rng`) and warp one record to a fixed-size crop.
        Returns uint8 `image` (H, W, 3), crop-space `joints` (J, 2),
        `joints_vis` (J,) and eval metadata."""
        import cv2

        rec = self.records[idx]
        img = self._read_image(rec["image"])
        joints = rec["joints_3d"].copy()
        joints_vis = rec["joints_3d_vis"].copy()
        c = np.asarray(rec["center"], np.float32).copy()
        s = np.asarray(rec["scale"], np.float32).copy()
        r = 0.0
        if self.is_train:
            joints, joints_vis, c, s, r, flipped = self._draw_augmentation(
                joints, joints_vis, c, s, img.shape[1], rng)
            if flipped:
                img = img[:, ::-1, :]

        trans = get_affine_transform(c, s, r, self.image_size)
        crop = cv2.warpAffine(
            img, trans, (int(self.image_size[0]), int(self.image_size[1])),
            flags=cv2.INTER_LINEAR,
        )
        for j in range(self.num_joints):
            if joints_vis[j, 0] > 0.0:
                joints[j, 0:2] = affine_transform(joints[j, 0:2], trans)

        return dict(
            image=np.ascontiguousarray(crop),
            joints=joints[:, :2].astype(np.float32),
            joints_vis=joints_vis[:, 0].astype(np.float32),
            center=c,
            scale=s,
            rotation=r,
            score=np.float32(rec.get("score", 1.0)),
            image_path=rec["image"],
        )

    def get_raw_sample(self, idx: int, rng: np.random.RandomState,
                       bucket_hw=(512, 768)) -> dict:
        """The sample for the on-device warp: the decoded image padded (or
        truncated, with a warning) into a uint8 bucket `bucket_hw`, and
        `warp_matrix`, the 2x3 crop matrix with the flip folded in. It
        draws from `rng` exactly as `get_sample` does, so both give the same
        geometry for a seed."""
        rec = self.records[idx]
        img = self._read_image(rec["image"])
        joints = rec["joints_3d"].copy()
        joints_vis = rec["joints_3d_vis"].copy()
        c = np.asarray(rec["center"], np.float32).copy()
        s = np.asarray(rec["scale"], np.float32).copy()
        r = 0.0
        flipped = False
        w_img = img.shape[1]
        if self.is_train:
            joints, joints_vis, c, s, r, flipped = self._draw_augmentation(
                joints, joints_vis, c, s, w_img, rng)

        trans = get_affine_transform(c, s, r, self.image_size)
        full = _compose_mirror(trans, w_img) if flipped else trans
        for j in range(self.num_joints):
            if joints_vis[j, 0] > 0.0:
                joints[j, 0:2] = affine_transform(joints[j, 0:2], trans)

        bh, bw = bucket_hw
        # empty + margin-only zeroing: np.zeros would write the whole
        # bucket before the image overwrites most of it
        padded = np.empty((bh, bw, 3), np.uint8)
        h0, w0 = min(img.shape[0], bh), min(img.shape[1], bw)
        if (img.shape[0] > bh or img.shape[1] > bw) and not getattr(
                self, "_warned_bucket_crop", False):
            # a truncated source corrupts any crop window that touches the
            # lost region: say so, once per dataset object
            self._warned_bucket_crop = True
            logging.getLogger(LOGGER_NAME).warning(
                "DEVICE_WARP bucket %s smaller than source image %s (%s): "
                "image truncated; raise DATASET.WARP_BUCKET to cover the "
                "dataset's largest image", (bh, bw), img.shape[:2],
                rec["image"])
        padded[:h0, :w0] = img[:h0, :w0]
        if w0 < bw:
            padded[:h0, w0:] = 0
        if h0 < bh:
            padded[h0:] = 0

        return dict(
            image=padded,
            warp_matrix=full.astype(np.float32),
            joints=joints[:, :2].astype(np.float32),
            joints_vis=joints_vis[:, 0].astype(np.float32),
            center=c,
            scale=s,
            rotation=np.float32(r),
            score=np.float32(rec.get("score", 1.0)),
            image_path=rec["image"],
        )

    def evaluate(self, cfg, preds, output_dir, all_boxes, img_path, **kwargs):
        raise NotImplementedError


class COCODataset(BaseJointsDataset):
    num_joints = 17
    flip_pairs = [[1, 2], [3, 4], [5, 6], [7, 8], [9, 10], [11, 12],
                  [13, 14], [15, 16]]
    upper_body_ids = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10)
    lower_body_ids = (11, 12, 13, 14, 15, 16)

    def __init__(self, cfg, is_train: bool, image_set: Optional[str] = None):
        super().__init__(cfg, is_train)
        self.image_set = image_set or (
            cfg.DATASET.TRAIN_SET if is_train else cfg.DATASET.TEST_SET)
        root = cfg.DATASET.ROOT
        prefix = ("person_keypoints" if "test" not in self.image_set
                  else "image_info")
        self.ann_file = os.path.join(
            root, "annotations", f"{prefix}_{self.image_set}.json")
        # zip archives: <set>.zip@<member> paths (lib/dataset/coco.py:235)
        image_dir = os.path.join(
            root, self.image_set + (".zip@" if cfg.DATASET.DATA_FORMAT == "zip"
                                    else ""))
        # COCO2014 sets carry a COCO_<set>_ filename prefix (coco.py:230-231)
        fname_prefix = (f"COCO_{self.image_set}_"
                        if "2014" in self.image_set else "")
        corruption = (cfg.TEST.CORRUPTION_TYPE
                      if (cfg.TEST.TEST_ROBUST and not is_train) else "")
        common = dict(corruption_type=corruption,
                      severity=cfg.TEST.SEVERITY,
                      root_c=cfg.DATASET.ROOT_C,
                      filename_prefix=fname_prefix)
        if is_train or cfg.TEST.USE_GT_BBOX or cfg.DATASET.MINI_COCO:
            self.records = records_lib.load_coco_gt_records(
                self.ann_file, image_dir, self.aspect_ratio, self.num_joints,
                max_images=200 if cfg.DATASET.MINI_COCO else None, **common)
        else:
            self.records = records_lib.load_coco_det_records(
                cfg.TEST.COCO_BBOX_FILE, image_dir, self.aspect_ratio,
                cfg.TEST.IMAGE_THRE, self.num_joints,
                max_boxes=100 if cfg.DATASET.MINI_COCO else None, **common)
        if is_train and cfg.DATASET.SELECT_DATA:
            self.records = records_lib.select_data(self.records)

    def evaluate(self, cfg, preds, output_dir, all_boxes, img_path,
                 device=None, **kwargs):
        from ..evaluation.coco_eval import evaluate_coco_keypoints

        return evaluate_coco_keypoints(cfg, self, preds, output_dir,
                                       all_boxes, img_path, device=device)


class MPIIDataset(BaseJointsDataset):
    num_joints = 16
    flip_pairs = [[0, 5], [1, 4], [2, 3], [10, 15], [11, 14], [12, 13]]
    parent_ids = [1, 2, 6, 6, 3, 4, 6, 6, 7, 8, 11, 12, 7, 7, 13, 14]
    upper_body_ids = (7, 8, 9, 10, 11, 12, 13, 14, 15)
    lower_body_ids = (0, 1, 2, 3, 4, 5, 6)

    def __init__(self, cfg, is_train: bool, image_set: Optional[str] = None):
        super().__init__(cfg, is_train)
        self.image_set = image_set or (
            cfg.DATASET.TRAIN_SET if is_train else cfg.DATASET.TEST_SET)
        corruption = (cfg.TEST.CORRUPTION_TYPE
                      if (cfg.TEST.TEST_ROBUST and not is_train) else "")
        self.records = records_lib.load_mpii_records(
            cfg.DATASET.ROOT, self.image_set, self.num_joints,
            corruption_type=corruption, severity=cfg.TEST.SEVERITY,
            root_c=cfg.DATASET.ROOT_C,
            # zip archives: images.zip@<member> (lib/dataset/mpii.py:92)
            image_dir_name=("images.zip@" if cfg.DATASET.DATA_FORMAT == "zip"
                            else "images"))
        if is_train and cfg.DATASET.SELECT_DATA:
            self.records = records_lib.select_data(self.records)

    def evaluate(self, cfg, preds, output_dir, all_boxes=None, img_path=None,
                 **kwargs):
        from ..evaluation.mpii_eval import evaluate_mpii_pckh

        return evaluate_mpii_pckh(cfg, self, preds, output_dir)


class SyntheticPoseDataset(BaseJointsDataset):
    """Random data with the full sample schema, for tests: a distinct
    marker per joint on a noisy background, so that a short training run
    can drive PCK up (the JAX package's `SyntheticPoseDataset`)."""

    def __init__(self, cfg, is_train: bool, length: int = 64):
        self.num_joints = cfg.MODEL.NUM_JOINTS
        self.flip_pairs = [[i, i + 1]
                           for i in range(0, self.num_joints - 1, 2)]
        self.upper_body_ids = tuple(range(self.num_joints // 2))
        self.lower_body_ids = tuple(range(self.num_joints // 2,
                                          self.num_joints))
        super().__init__(cfg, is_train)
        rng = np.random.RandomState(0)
        for i in range(length):
            joints = np.zeros((self.num_joints, 3))
            joints[:, 0] = rng.uniform(40, 240, self.num_joints)
            joints[:, 1] = rng.uniform(40, 240, self.num_joints)
            vis = np.ones((self.num_joints, 3))
            vis[:, 2] = 0
            self.records.append(dict(
                image=f"synthetic://{i}",
                center=np.array([140.0, 140.0], np.float32),
                scale=np.array([1.0, 1.0], np.float32),
                joints_3d=joints,
                joints_3d_vis=vis,
                score=1.0,
            ))

    def _read_image(self, path: str) -> np.ndarray:
        import cv2

        idx = int(path.split("://")[1])
        rng = np.random.RandomState(idx)
        img = rng.randint(0, 80, (280, 280, 3)).astype(np.uint8)
        joints = self.records[idx]["joints_3d"]
        for j in range(self.num_joints):
            x, y = int(joints[j, 0]), int(joints[j, 1])
            color = (
                int(255 * ((j * 37) % 7) / 6),
                int(255 * ((j * 53) % 5) / 4),
                int(255 * ((j * 11) % 3) / 2),
            )
            cv2.circle(img, (x, y), 12, color, -1)
            cv2.circle(img, (x, y), 5, (255, 255, 255), -1)
        return img

    def evaluate(self, cfg, preds, output_dir, all_boxes=None, img_path=None,
                 indices=None, **kwargs):
        """PCK@0.1 in original-image coordinates against the known GT;
        predictions must be the complete set in dataset order."""
        if preds.shape[0] != len(self.records):
            raise ValueError(f"got {preds.shape[0]} predictions for "
                             f"{len(self.records)} records")
        if indices is not None and not np.array_equal(
                np.asarray(indices), np.arange(len(self.records))):
            raise ValueError("predictions are not in dataset order")
        hits = total = 0
        for i, rec in enumerate(self.records):
            gt = np.asarray(rec["joints_3d"])[:, :2]
            vis = np.asarray(rec["joints_3d_vis"])[:, 0] > 0
            thr = 0.1 * 200.0 * float(np.max(rec["scale"]))
            d = np.linalg.norm(preds[i, :, :2] - gt, axis=1)
            hits += int(np.sum((d < thr) & vis))
            total += int(np.sum(vis))
        pck = hits / max(total, 1)
        return OrderedDict([("PCK", pck)]), pck


def build_dataset(cfg, is_train: bool = False,
                  image_set: Optional[str] = None):
    """The train or eval dataset of cfg.DATASET.DATASET."""
    name = cfg.DATASET.DATASET
    if name == "coco":
        return COCODataset(cfg, is_train, image_set)
    if name == "mpii":
        return MPIIDataset(cfg, is_train, image_set)
    if name == "synthetic":
        return SyntheticPoseDataset(
            cfg, is_train, length=int(cfg.DATASET.SYNTH_LENGTH))
    if name in ("bottomup_coco", "ochuman"):
        # OCHuman ships COCO-format person_keypoints json: the same loader
        from .bottomup import BottomUpCOCODataset

        return BottomUpCOCODataset(cfg, is_train, image_set)
    raise KeyError(f"unknown dataset '{name}'")


class ConcatDataset:
    """The concatenation of datasets of one sample schema: the reference's
    --stylize_image training set (`tools/train.py:145-163`), the normal
    dataset and its stylized copy. `style_tags` gives each child a 0/1
    float that its samples carry as `is_style` (the reference tags
    stylized records with dataset='style', `advaug.py:182,192`)."""

    def __init__(self, datasets, style_tags):
        assert datasets and len(style_tags) == len(datasets)
        self.datasets = list(datasets)
        self.style_tags = list(style_tags)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def _owner(self, idx: int):
        """(child, index in the child, style tag) of sample `idx`."""
        if not 0 <= idx < len(self):
            raise IndexError(idx)
        k = int(np.searchsorted(self._offsets, idx, side="right")) - 1
        return self.datasets[k], idx - int(self._offsets[k]), \
            self.style_tags[k]

    def get_sample(self, idx: int, rng: np.random.RandomState) -> dict:
        d, i, tag = self._owner(idx)
        sample = d.get_sample(i, rng)
        sample["is_style"] = np.float32(tag)
        return sample

    def get_raw_sample(self, idx: int, rng: np.random.RandomState,
                       bucket_hw=(512, 768)) -> dict:
        d, i, tag = self._owner(idx)
        sample = d.get_raw_sample(i, rng, bucket_hw)
        sample["is_style"] = np.float32(tag)
        return sample

    def evaluate(self, *args, **kwargs):
        return self.datasets[0].evaluate(*args, **kwargs)


def build_stylized_dataset(cfg, is_train: bool, build=build_dataset):
    """`build(cfg, is_train)` with DATASET.ROOT moved to the stylized copy,
    `<dirname(ROOT)>/stylize_image_<DATASET>`."""
    styl_cfg = cfg.clone()
    styl_cfg.defrost()
    root = cfg.DATASET.ROOT.rstrip("/")
    styl_cfg.DATASET.ROOT = os.path.join(
        os.path.dirname(root), f"stylize_image_{cfg.DATASET.DATASET}")
    styl_cfg.freeze()
    return build(styl_cfg, is_train)
