"""COCO and MPII annotation -> record loaders (host side, numpy).

Port of `advmix_tpu/data/records.py`, producing the same fixed-schema
records as the reference's `_get_db` (`lib/dataset/coco.py:118-293`: GT
keypoint annotations, or detected person boxes filtered by IMAGE_THRE; box
-> center/scale with the aspect-ratio fixup and the 1.25 padding;
`lib/dataset/mpii.py:50-112`: the annot json's center and scale with the
+15*s shift, the 1.25 padding and 1-based -> 0-based coordinates).

Record schema: dict(image, center(2,), scale(2,), joints_3d(J,3),
joints_3d_vis(J,3), score, filename, imgnum, instance_index).
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

PIXEL_STD = 200.0


def xywh_to_center_scale(x, y, w, h, aspect_ratio: float) -> tuple:
    """Box -> (center, scale) with the reference's conventions
    (`lib/dataset/coco.py:205-220`)."""
    center = np.array([x + w * 0.5, y + h * 0.5], dtype=np.float32)
    if w > aspect_ratio * h:
        h = w * 1.0 / aspect_ratio
    elif w < aspect_ratio * h:
        w = h * aspect_ratio
    scale = np.array([w / PIXEL_STD, h / PIXEL_STD], dtype=np.float32)
    if center[0] != -1:
        scale = scale * 1.25
    return center, scale


def _corruption_subpath(file_name: str, corruption_type: str, severity: int) -> str:
    return os.path.join(corruption_type, str(severity), file_name)


def load_coco_gt_records(
    ann_file: str,
    image_dir: str,
    aspect_ratio: float,
    num_joints: int = 17,
    max_images: Optional[int] = None,
    corruption_type: str = "",
    severity: int = 0,
    root_c: str = "",
    filename_prefix: str = "",
    coco: Optional[dict] = None,
) -> List[dict]:
    """Ground-truth COCO keypoint records (no pycocotools dependency).
    `coco` takes the already-parsed annotation file, for a caller that
    also reads other parts of it (the bottom-up ignore masks)."""
    if coco is None:
        with open(ann_file) as f:
            coco = json.load(f)

    images = {im["id"]: im for im in coco["images"]}
    image_ids = sorted(images.keys())
    if max_images:
        image_ids = image_ids[:max_images]
    id_set = set(image_ids)

    person_cat = 1
    anns_by_image: dict = {}
    for ann in coco.get("annotations", []):
        if ann.get("iscrowd", 0):
            continue
        if ann["image_id"] in id_set:
            anns_by_image.setdefault(ann["image_id"], []).append(ann)

    records = []
    for img_id in image_ids:
        im = images[img_id]
        width, height = im["width"], im["height"]
        # COCO2014 sets prefix filenames (e.g. COCO_val2014_%012d.jpg,
        # lib/dataset/coco.py:230-231)
        file_name = filename_prefix + "%012d.jpg" % img_id
        if corruption_type and corruption_type != "clean":
            path = os.path.join(
                root_c, _corruption_subpath(file_name, corruption_type, severity)
            )
        else:
            path = os.path.join(image_dir, file_name)

        for kobj, ann in enumerate(anns_by_image.get(img_id, [])):
            if ann.get("category_id", 1) != person_cat:
                continue
            kps = ann.get("keypoints", [])
            if not kps or max(kps) == 0:
                continue
            x, y, w, h = ann["bbox"]
            x1, y1 = max(0, x), max(0, y)
            x2 = min(width - 1, x1 + max(0, w - 1))
            y2 = min(height - 1, y1 + max(0, h - 1))
            if ann.get("area", 0) <= 0 or x2 < x1 or y2 < y1:
                continue

            joints = np.zeros((num_joints, 3), np.float64)
            vis = np.zeros((num_joints, 3), np.float64)
            for j in range(num_joints):
                joints[j, 0] = kps[j * 3 + 0]
                joints[j, 1] = kps[j * 3 + 1]
                v = min(1, kps[j * 3 + 2])
                vis[j, 0] = vis[j, 1] = v

            center, scale = xywh_to_center_scale(
                x1, y1, x2 - x1, y2 - y1, aspect_ratio
            )
            records.append(
                dict(
                    image=path,
                    center=center,
                    scale=scale,
                    joints_3d=joints,
                    joints_3d_vis=vis,
                    score=1.0,
                    filename="",
                    imgnum=0,
                    instance_index=f"{img_id}_{kobj}",
                )
            )
    return records


def load_coco_det_records(
    bbox_file: str,
    image_dir: str,
    aspect_ratio: float,
    image_thre: float,
    num_joints: int = 17,
    max_boxes: Optional[int] = None,
    corruption_type: str = "",
    severity: int = 0,
    root_c: str = "",
    filename_prefix: str = "",
) -> List[dict]:
    """Detected-person-box records (`lib/dataset/coco.py:249-293`)."""
    with open(bbox_file) as f:
        all_boxes = json.load(f)
    if max_boxes:
        all_boxes = all_boxes[:max_boxes]

    records = []
    for det in all_boxes:
        if det.get("category_id", 1) != 1:
            continue
        score = det["score"]
        if score < image_thre:
            continue
        img_id = det["image_id"]
        file_name = filename_prefix + "%012d.jpg" % img_id
        if corruption_type and corruption_type != "clean":
            path = os.path.join(
                root_c, _corruption_subpath(file_name, corruption_type, severity)
            )
        else:
            path = os.path.join(image_dir, file_name)
        x, y, w, h = det["bbox"]
        center, scale = xywh_to_center_scale(x, y, w, h, aspect_ratio)
        records.append(
            dict(
                image=path,
                center=center,
                scale=scale,
                joints_3d=np.zeros((num_joints, 3), np.float64),
                joints_3d_vis=np.ones((num_joints, 3), np.float64),
                score=float(score),
                filename="",
                imgnum=0,
                instance_index=str(img_id),
            )
        )
    return records


def load_mpii_records(
    root: str,
    image_set: str,
    num_joints: int = 16,
    corruption_type: str = "",
    severity: int = 0,
    root_c: str = "",
    image_dir_name: str = "images",
) -> List[dict]:
    """MPII records from annot/<set>.json (`lib/dataset/mpii.py:50-112`).
    `image_dir_name` is `images.zip@` for a zip archive."""
    ann_file = os.path.join(root, "annot", image_set + ".json")
    with open(ann_file) as f:
        anno = json.load(f)

    records = []
    for a in anno:
        image_name = a["image"]
        if corruption_type and corruption_type != "clean":
            path = os.path.join(
                root_c, _corruption_subpath(image_name, corruption_type,
                                            severity))
        else:
            path = os.path.join(root, image_dir_name, image_name)

        c = np.array(a["center"], dtype=np.float64)
        s = np.array([a["scale"], a["scale"]], dtype=np.float64)
        if c[0] != -1:
            c[1] = c[1] + 15 * s[1]
            s = s * 1.25
        c = c - 1  # matlab 1-based -> 0-based

        joints = np.zeros((num_joints, 3), np.float64)
        vis = np.zeros((num_joints, 3), np.float64)
        if image_set != "test":
            j = np.array(a["joints"], dtype=np.float64)
            j[:, 0:2] = j[:, 0:2] - 1
            jv = np.array(a["joints_vis"], dtype=np.float64)
            assert len(j) == num_joints
            joints[:, 0:2] = j[:, 0:2]
            vis[:, 0] = jv
            vis[:, 1] = jv

        records.append(dict(
            image=path,
            center=c.astype(np.float32),
            scale=s.astype(np.float32),
            joints_3d=joints,
            joints_3d_vis=vis,
            score=1.0,
            filename="",
            imgnum=0,
            instance_index="",
        ))
    return records


def select_data(records: List[dict]) -> List[dict]:
    """ks-metric record filtering (`lib/dataset/JointsDataset.py:366-399`)."""
    selected = []
    for rec in records:
        vis = rec["joints_3d_vis"][:, 0] > 0
        num_vis = int(vis.sum())
        if num_vis == 0:
            continue
        joints_center = rec["joints_3d"][vis, :2].mean(axis=0)
        area = rec["scale"][0] * rec["scale"][1] * (PIXEL_STD**2)
        diff = np.linalg.norm(joints_center - np.asarray(rec["center"]))
        ks = np.exp(-1.0 * (diff**2) / ((0.2**2) * 2.0 * area))
        metric = (0.2 / 16) * num_vis + 0.45 - 0.2 / 16
        if ks > metric:
            selected.append(rec)
    return selected
