"""Bottom-up (multi-person, whole-image) dataset.

Port of `advmix_tpu/data/bottomup.py` (public HigherHRNet data recipe): the
whole image affine-resized to INPUT x INPUT (512) with random scale,
rotation and flip at train time; every person's keypoints kept, padded to
MAX_PEOPLE; the targets of the 1/4 and 1/2 heads are made on the device.
COCO-format annotation files cover both COCO and OCHuman (DATASET.DATASET
`bottomup_coco` or `ochuman`).

A training sample also carries `mask`, the (S, S) f32 VALID mask
(`data/masks.py`) warped with the image; an eval sample carries none. A
sample: uint8 `image` (S, S, 3), `joints` (MAX_PEOPLE, J, 2) in input
coordinates, `joints_vis` (MAX_PEOPLE, J), with joints warped outside the
input made invisible, and the eval metadata `center`, `scale`.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from ..ops.transforms import affine_transform, get_affine_transform
from . import masks as masks_lib
from . import records as records_lib
from .datasets import BaseJointsDataset

MAX_PEOPLE = 30


class BottomUpCOCODataset(BaseJointsDataset):
    num_joints = 17
    flip_pairs = [[1, 2], [3, 4], [5, 6], [7, 8], [9, 10], [11, 12],
                  [13, 14], [15, 16]]

    def __init__(self, cfg, is_train: bool, image_set: Optional[str] = None):
        super().__init__(cfg, is_train)
        self.image_set = image_set or (
            cfg.DATASET.TRAIN_SET if is_train else cfg.DATASET.TEST_SET)
        self.max_people = MAX_PEOPLE
        root = cfg.DATASET.ROOT
        prefix = ("person_keypoints" if "test" not in self.image_set
                  else "image_info")
        self.ann_file = os.path.join(
            root, "annotations", f"{prefix}_{self.image_set}.json")
        image_dir = os.path.join(root, self.image_set)
        corruption = (cfg.TEST.CORRUPTION_TYPE
                      if (cfg.TEST.TEST_ROBUST and not is_train) else "")
        max_images = 200 if cfg.DATASET.MINI_COCO else None
        # one json.load serves the records and the ignore segmentations
        with open(self.ann_file) as f:
            coco = json.load(f)
        per_person = records_lib.load_coco_gt_records(
            self.ann_file, image_dir, self.aspect_ratio, self.num_joints,
            max_images=max_images, corruption_type=corruption,
            severity=cfg.TEST.SEVERITY, root_c=cfg.DATASET.ROOT_C, coco=coco)
        by_image: dict = {}
        for rec in per_person:
            by_image.setdefault(rec["image"], []).append(rec)
        # crowd / zero-keypoint / degenerate-box regions, for the training
        # loss only
        ignore = (masks_lib.load_coco_ignore_segs(
            self.ann_file, max_images=max_images, coco=coco)
            if is_train else {})
        del coco
        self.records = []
        for path, recs in by_image.items():
            img_id = int(recs[0]["instance_index"].split("_")[0])
            info = ignore.get(img_id, {"segs": []})
            self.records.append(
                dict(image=path, people=recs, ignore_segs=info["segs"]))

    def get_sample(self, idx: int, rng: np.random.RandomState) -> dict:
        import cv2

        rec = self.records[idx]
        img = self._read_image(rec["image"])
        h, w = img.shape[:2]
        input_size = int(self.image_size[0])  # square input
        # the VALID mask rides the same flip and affine as the image, at
        # input resolution (the step resizes it to each output scale)
        valid = (masks_lib.build_valid_mask(rec.get("ignore_segs"), h, w)
                 if self.is_train else None)

        center = np.array([w / 2.0, h / 2.0], np.float32)
        scale = np.array([max(h, w) / 200.0, max(h, w) / 200.0], np.float32)
        r = 0.0

        joints = np.zeros((self.max_people, self.num_joints, 2), np.float32)
        vis = np.zeros((self.max_people, self.num_joints), np.float32)
        people = rec["people"][: self.max_people]
        for m, p in enumerate(people):
            joints[m] = p["joints_3d"][:, :2]
            vis[m] = p["joints_3d_vis"][:, 0]

        if self.is_train:
            sf, rf = self.scale_factor, self.rotation_factor
            scale = scale * np.clip(rng.randn() * sf + 1, 1 - sf, 1 + sf)
            r = (float(np.clip(rng.randn() * rf, -rf * 2, rf * 2))
                 if rng.rand() <= 0.6 else 0.0)
            if self.flip and rng.rand() <= 0.5:
                img = img[:, ::-1, :]
                if valid is not None:
                    valid = valid[:, ::-1]
                joints[:, :, 0] = w - joints[:, :, 0] - 1
                for a, b in self.flip_pairs:
                    joints[:, [a, b]] = joints[:, [b, a]]
                    vis[:, [a, b]] = vis[:, [b, a]]
                center[0] = w - center[0] - 1

        trans = get_affine_transform(center, scale, r,
                                     (input_size, input_size))
        crop = cv2.warpAffine(img, trans, (input_size, input_size),
                              flags=cv2.INTER_LINEAR)
        mask = None
        if valid is not None:
            # the area outside the image warps in as 0: ignored
            mask = cv2.warpAffine(valid, trans, (input_size, input_size),
                                  flags=cv2.INTER_LINEAR)
            mask = (mask > 0.5).astype(np.float32)
        for m in range(len(people)):
            for j in range(self.num_joints):
                if vis[m, j] > 0:
                    joints[m, j] = affine_transform(joints[m, j], trans)
                    if not (0 <= joints[m, j][0] < input_size
                            and 0 <= joints[m, j][1] < input_size):
                        vis[m, j] = 0

        out = dict(
            image=np.ascontiguousarray(crop),
            joints=joints,
            joints_vis=vis,
            center=center,
            scale=scale,
            rotation=np.float32(r),
            score=np.float32(1.0),
            image_path=rec["image"],
            instance_index="",
        )
        if mask is not None:
            out["mask"] = mask
        return out
