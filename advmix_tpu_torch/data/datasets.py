"""Datasets: host-side records and the per-sample eval crop.

Port of the eval path of `advmix_tpu/data/datasets.py` (reference
`lib/dataset/JointsDataset.py`, `lib/dataset/coco.py:70-83`). The host
decodes the image and warps a fixed-size uint8 crop with cv2; everything
after (normalization, targets) runs batched on the device. `cv2` is
imported where a JPEG is decoded or a crop warped, so importing the
package does not need it.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import List, Optional

import numpy as np

from ..ops.transforms import affine_transform, get_affine_transform
from . import records as records_lib


class BaseJointsDataset:
    num_joints: int = 0
    flip_pairs: List[List[int]] = []

    def __init__(self, cfg, is_train: bool):
        if is_train:
            raise NotImplementedError(
                "training datasets (augmentation) are not ported yet")
        self.cfg = cfg
        self.is_train = is_train
        self.image_size = np.array(cfg.MODEL.IMAGE_SIZE)  # (w, h)
        self.heatmap_size = np.array(cfg.MODEL.HEATMAP_SIZE)
        self.color_rgb = cfg.DATASET.COLOR_RGB
        self.aspect_ratio = self.image_size[0] / self.image_size[1]
        self.records: List[dict] = []

    def __len__(self):
        return len(self.records)

    def _read_image(self, path: str) -> np.ndarray:
        import cv2

        flags = cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION
        img = cv2.imread(path, flags)
        if img is None:
            raise ValueError(f"Fail to read {path}")
        if self.color_rgb:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        return img

    def get_sample(self, idx: int, rng: np.random.RandomState) -> dict:
        """Decode + warp one record to a fixed-size crop (the eval branch
        of `JointsDataset.__getitem__`: no augmentation, so `rng` is not
        drawn from). Returns uint8 `image` (H, W, 3), crop-space `joints`
        (J, 2), `joints_vis` (J,) and eval metadata."""
        import cv2

        rec = self.records[idx]
        img = self._read_image(rec["image"])
        joints = rec["joints_3d"].copy()
        joints_vis = rec["joints_3d_vis"].copy()
        c = np.asarray(rec["center"], np.float32).copy()
        s = np.asarray(rec["scale"], np.float32).copy()

        trans = get_affine_transform(c, s, 0.0, self.image_size)
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
            score=np.float32(rec.get("score", 1.0)),
            image_path=rec["image"],
        )

    def evaluate(self, cfg, preds, output_dir, all_boxes, img_path, **kwargs):
        raise NotImplementedError


class COCODataset(BaseJointsDataset):
    num_joints = 17
    flip_pairs = [[1, 2], [3, 4], [5, 6], [7, 8], [9, 10], [11, 12],
                  [13, 14], [15, 16]]

    def __init__(self, cfg, is_train: bool, image_set: Optional[str] = None):
        super().__init__(cfg, is_train)
        self.image_set = image_set or cfg.DATASET.TEST_SET
        root = cfg.DATASET.ROOT
        prefix = ("person_keypoints" if "test" not in self.image_set
                  else "image_info")
        self.ann_file = os.path.join(
            root, "annotations", f"{prefix}_{self.image_set}.json")
        if cfg.DATASET.DATA_FORMAT == "zip":
            raise NotImplementedError("zip image archives are not ported yet")
        image_dir = os.path.join(root, self.image_set)
        # COCO2014 sets carry a COCO_<set>_ filename prefix (coco.py:230-231)
        fname_prefix = (f"COCO_{self.image_set}_"
                        if "2014" in self.image_set else "")
        corruption = cfg.TEST.CORRUPTION_TYPE if cfg.TEST.TEST_ROBUST else ""
        common = dict(corruption_type=corruption,
                      severity=cfg.TEST.SEVERITY,
                      root_c=cfg.DATASET.ROOT_C,
                      filename_prefix=fname_prefix)
        if cfg.TEST.USE_GT_BBOX or cfg.DATASET.MINI_COCO:
            self.records = records_lib.load_coco_gt_records(
                self.ann_file, image_dir, self.aspect_ratio, self.num_joints,
                max_images=200 if cfg.DATASET.MINI_COCO else None, **common)
        else:
            self.records = records_lib.load_coco_det_records(
                cfg.TEST.COCO_BBOX_FILE, image_dir, self.aspect_ratio,
                cfg.TEST.IMAGE_THRE, self.num_joints,
                max_boxes=100 if cfg.DATASET.MINI_COCO else None, **common)

    def evaluate(self, cfg, preds, output_dir, all_boxes, img_path,
                 device=None, **kwargs):
        from ..evaluation.coco_eval import evaluate_coco_keypoints

        return evaluate_coco_keypoints(cfg, self, preds, output_dir,
                                       all_boxes, img_path, device=device)


class SyntheticPoseDataset(BaseJointsDataset):
    """Random data with the full sample schema, for tests: a distinct
    marker per joint on a noisy background (the JAX package's
    `SyntheticPoseDataset`, eval side)."""

    def __init__(self, cfg, is_train: bool, length: int = 64):
        self.num_joints = cfg.MODEL.NUM_JOINTS
        self.flip_pairs = [[i, i + 1]
                           for i in range(0, self.num_joints - 1, 2)]
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
    name = cfg.DATASET.DATASET
    if name == "coco":
        return COCODataset(cfg, is_train, image_set)
    if name == "synthetic":
        return SyntheticPoseDataset(
            cfg, is_train, length=int(cfg.DATASET.SYNTH_LENGTH))
    raise NotImplementedError(f"dataset '{name}' is not ported yet")
