"""COCO ignore-region masks (host side, numpy + cv2).

The port's copy of `advmix_tpu/data/masks.py` (public HigherHRNet mask
recipe): a per-image binary VALID mask built from the annotations the
keypoint record loader skips (crowd segments, people with no annotated
keypoint, degenerate boxes), which multiplies the bottom-up heatmap loss so
the network is not penalized for firing on unannotated people.

COCO stores segmentations in three forms, all handled without pycocotools:
- polygons: list of flat [x0, y0, x1, y1, ...] rings -> cv2.fillPoly
- uncompressed RLE: {"counts": [int...], "size": [h, w]}
- compressed RLE: {"counts": "<ascii>", "size": [h, w]} (the LEB128-style
  char encoding of pycocotools' rleFrString, mask.c)

COCO RLE runs are column-major (Fortran order), alternating 0-runs and
1-runs starting with zeros. cv2 is imported where a polygon is filled or
a mask resized, so importing the module does not need it.
"""

from __future__ import annotations

import json
from typing import List, Optional

import numpy as np


def rle_string_to_counts(s: str) -> List[int]:
    """Decode pycocotools' compressed-RLE char string into run counts
    (mask.c rleFrString: 5-bit groups, bit 0x20 = continuation, sign
    extension via 0x10, and every count after the second is delta-coded
    against the count two back)."""
    counts: List[int] = []
    p = 0
    n = len(s)
    while p < n:
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[p]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def rle_decode(counts, h: int, w: int) -> np.ndarray:
    """Run-length counts -> (h, w) uint8 mask (column-major runs)."""
    if isinstance(counts, str):
        counts = rle_string_to_counts(counts)
    counts = np.asarray(counts, np.int64)
    total = int(counts.sum())
    if total != h * w:
        # tolerate truncated/padded streams: clamp into the canvas
        flat = np.zeros(h * w, np.uint8)
        vals = np.repeat(np.arange(len(counts)) % 2, counts).astype(np.uint8)
        flat[: min(total, h * w)] = vals[: h * w]
    else:
        flat = np.repeat(np.arange(len(counts)) % 2, counts).astype(np.uint8)
    return flat.reshape((w, h)).T  # column-major -> (h, w)


def seg_to_mask(seg, h: int, w: int) -> np.ndarray:
    """One COCO segmentation (polygons or RLE dict) -> (h, w) uint8."""
    import cv2

    if isinstance(seg, dict):
        sh, sw = seg.get("size", (h, w))
        m = rle_decode(seg["counts"], int(sh), int(sw))
        if m.shape != (h, w):  # defensive; size should match the image
            m = cv2.resize(m, (w, h), interpolation=cv2.INTER_NEAREST)
        return m
    m = np.zeros((h, w), np.uint8)
    polys = [
        np.asarray(p, np.float64).reshape(-1, 2).round().astype(np.int32)
        for p in seg
        if len(p) >= 6
    ]
    if polys:
        cv2.fillPoly(m, polys, 1)
    return m


def build_valid_mask(segs, h: int, w: int) -> np.ndarray:
    """Ignore segmentations -> float32 (h, w) VALID mask (1 = supervise,
    0 = ignore). Empty list -> all ones."""
    valid = np.ones((h, w), np.float32)
    for seg in segs or []:
        valid[seg_to_mask(seg, h, w) > 0] = 0.0
    return valid


def load_coco_ignore_segs(
    ann_file: str, max_images: Optional[int] = None, coco: Optional[dict] = None
) -> dict:
    """Per-image ignore segmentations from a COCO keypoint json.

    Returns {image_id: {"segs": [segmentation, ...], "hw": (h, w)}} for
    every image (empty seg list when nothing is ignored). An annotation is
    an ignore region iff the GT record loader skips it
    (records.load_coco_gt_records): crowd (`iscrowd=1`), a person with no
    annotated keypoints, or a person with a degenerate box/area
    (records.py's area<=0 / clipped-empty-bbox skip) — every skipped person
    is unsupervised, so firing on them must not be penalized (the public
    HigherHRNet mask recipe).

    Pass `coco` (the already-parsed annotation dict) to share one
    json.load with the record loader — the train jsons are hundreds of MB.
    """
    if coco is None:
        with open(ann_file) as f:
            coco = json.load(f)
    images = {im["id"]: im for im in coco["images"]}
    image_ids = sorted(images.keys())
    if max_images:
        image_ids = image_ids[:max_images]
    out = {
        iid: {
            "segs": [],
            "hw": (images[iid]["height"], images[iid]["width"]),
        }
        for iid in image_ids
    }
    for ann in coco.get("annotations", []):
        iid = ann.get("image_id")
        if iid not in out or ann.get("category_id", 1) != 1:
            continue
        seg = ann.get("segmentation")
        if not seg:
            continue
        kps = ann.get("keypoints", [])
        unannotated = (not kps) or max(kps) == 0
        # mirror records.load_coco_gt_records' degenerate-box skip exactly
        width = images[iid]["width"]
        height = images[iid]["height"]
        x, y, w, h = ann.get("bbox", (0, 0, 0, 0))
        x1, y1 = max(0, x), max(0, y)
        x2 = min(width - 1, x1 + max(0, w - 1))
        y2 = min(height - 1, y1 + max(0, h - 1))
        degenerate = ann.get("area", 0) <= 0 or x2 < x1 or y2 < y1
        if ann.get("iscrowd", 0) or unannotated or degenerate:
            out[iid]["segs"].append(seg)
    return out
