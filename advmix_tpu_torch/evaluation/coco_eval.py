"""COCO keypoint evaluation driver.

Port of `advmix_tpu/evaluation/coco_eval.py` (reference
`COCODataset.evaluate`, `lib/dataset/coco.py:295-454`): rescoring (mean
keypoint score above IN_VIS_THRE times the box score), per-image OKS-NMS,
the results json with the reference's schema, then COCO keypoint AP.

OKS-NMS takes the routes of the JAX package with the device kernels on the
card instead of the TPU: when the evaluation device is CUDA, every image
with 2..128 candidates gets its OKS matrix from ONE batched launch of the
OKS kernel (once the pass has at least 16 such images), an image with 96 or
more candidates outside that set gets a single-image launch, and the
greedy scans stay on the host in C++. Elsewhere OKS-NMS runs in C++ alone.
"""

from __future__ import annotations

import json
import os
from collections import OrderedDict, defaultdict

import numpy as np
import torch

from ..native import greedy_from_matrix, oks_nms, soft_oks_nms
from ..ops.cuda.oks_kernel import oks_matrix, oks_matrix_batched
from .cocoeval_np import STATS_NAMES, COCOKeypointEval

# thresholds of advmix_tpu/evaluation/coco_eval.py:28-30
PALLAS_NMS_MIN_CANDIDATES = 96
PALLAS_BATCHED_MIN_IMAGES = 16
PALLAS_BATCHED_MAX_CANDIDATES = 128


def _oks_matrices_batched(cand, num_joints, device):
    """All candidates' OKS matrices in one launch. cand: list of
    (image_id, img_kpts); images are padded to the largest candidate count
    rounded up to a power of two. Returns {image_id: (n, n) matrix}."""
    m = len(cand)
    p = 1
    maxn = max(len(kp) for _, kp in cand)
    while p < maxn:
        p *= 2
    kpts = np.zeros((m, p, num_joints, 2), np.float32)
    areas = np.zeros((m, p), np.float32)
    for i, (_, img_kpts) in enumerate(cand):
        for k, pp in enumerate(img_kpts):
            kpts[i, k] = np.asarray(pp["keypoints"])[:, :2]
            areas[i, k] = pp["area"]
    sims = oks_matrix_batched(torch.from_numpy(kpts).to(device),
                              torch.from_numpy(areas).to(device))
    sims = sims.cpu().numpy()
    return {iid: sims[i][: len(kp), : len(kp)]
            for i, (iid, kp) in enumerate(cand)}


def _oks_nms_device(kpts_flat: np.ndarray, scores: np.ndarray,
                    areas: np.ndarray, thresh: float, device):
    """Greedy OKS-NMS with one image's OKS matrix from the device kernel
    and the greedy scan on the host."""
    n = kpts_flat.shape[0]
    kpts = kpts_flat.reshape(n, -1, 3)[:, :, :2].astype(np.float32)
    sim = oks_matrix(torch.from_numpy(kpts).to(device),
                     torch.from_numpy(areas.astype(np.float32)).to(device))
    return greedy_from_matrix(sim.cpu().numpy(), scores.astype(np.float32),
                              thresh)


def evaluate_coco_keypoints(cfg, dataset, preds, output_dir, all_boxes,
                            img_path, device=None):
    """preds: (N, J, 3) in original image coords; all_boxes: (N, 6)
    [center(2), scale(2), area, score]; img_path: list of image paths.
    `device` is the evaluation device; CUDA routes OKS-NMS through the
    kernels."""
    on_card = device is not None and torch.device(device).type == "cuda"
    res_folder = os.path.join(output_dir, "results")
    os.makedirs(res_folder, exist_ok=True)
    if cfg.TEST.TEST_ROBUST and cfg.TEST.CORRUPTION_TYPE != "clean":
        res_file = os.path.join(
            res_folder, "keypoints_{}_results_{}_{}_{}.json".format(
                dataset.image_set, cfg.RANK, cfg.TEST.CORRUPTION_TYPE,
                cfg.TEST.SEVERITY))
    else:
        res_file = os.path.join(
            res_folder, f"keypoints_{dataset.image_set}_results_{cfg.RANK}.json")

    num_joints = dataset.num_joints
    in_vis_thre = cfg.TEST.IN_VIS_THRE
    oks_thre = cfg.TEST.OKS_THRE

    # group by image; the reference parses the 12-digit id from the path
    # (coco.py:322)
    by_image = defaultdict(list)
    for idx in range(len(preds)):
        image_id = int(str(img_path[idx])[-16:-4])
        by_image[image_id].append(dict(
            keypoints=np.asarray(preds[idx]),
            center=np.asarray(all_boxes[idx][0:2]),
            scale=np.asarray(all_boxes[idx][2:4]),
            area=float(all_boxes[idx][4]),
            score=float(all_boxes[idx][5]),
            image=image_id,
        ))

    # rescore: kpt_score * box_score (coco.py:339-353)
    for img_kpts in by_image.values():
        for p in img_kpts:
            kpt_scores = p["keypoints"][:, 2]
            visible = kpt_scores > in_vis_thre
            kpt_score = float(kpt_scores[visible].mean()) if visible.any() \
                else 0.0
            p["score"] = kpt_score * p["score"]

    batched_sims = {}
    if not cfg.TEST.SOFT_NMS and on_card:
        cand = [(iid, kp) for iid, kp in by_image.items()
                if 2 <= len(kp) <= PALLAS_BATCHED_MAX_CANDIDATES]
        if len(cand) >= PALLAS_BATCHED_MIN_IMAGES:
            batched_sims = _oks_matrices_batched(cand, num_joints, device)

    oks_nmsed = []
    for image_id, img_kpts in by_image.items():
        kpts_flat = np.array([p["keypoints"].flatten() for p in img_kpts])
        scores = np.array([p["score"] for p in img_kpts])
        areas = np.array([p["area"] for p in img_kpts])
        if cfg.TEST.SOFT_NMS:
            keep = soft_oks_nms(kpts_flat, scores, areas, oks_thre)
        elif image_id in batched_sims:
            keep = greedy_from_matrix(batched_sims[image_id],
                                      scores.astype(np.float32), oks_thre)
        elif len(img_kpts) >= PALLAS_NMS_MIN_CANDIDATES and on_card:
            keep = _oks_nms_device(kpts_flat, scores, areas, oks_thre, device)
        else:
            keep = oks_nms(kpts_flat, scores, areas, oks_thre)
        oks_nmsed.append([img_kpts[k] for k in keep] if keep else img_kpts)

    # results json (schema per coco.py:408-439)
    results = []
    for img_kpts in oks_nmsed:
        for p in img_kpts:
            kp = np.zeros(num_joints * 3)
            kp[0::3] = p["keypoints"][:, 0]
            kp[1::3] = p["keypoints"][:, 1]
            kp[2::3] = p["keypoints"][:, 2]
            results.append(dict(
                image_id=p["image"],
                category_id=1,
                keypoints=[float(v) for v in kp],
                score=float(p["score"]),
                center=[float(v) for v in p["center"]],
                scale=[float(v) for v in p["scale"]],
            ))
    with open(res_file, "w") as f:
        json.dump(results, f, sort_keys=True, indent=4)

    if "test" in dataset.image_set:
        return {"Null": 0}, 0

    stats = COCOKeypointEval(dataset.ann_file, results).run()
    name_value = OrderedDict(zip(STATS_NAMES, [float(s) for s in stats]))
    return name_value, name_value["AP"]
