"""OKS-NMS numpy oracles and the COCO keypoint sigmas.

Port of the numpy half of `advmix_tpu/ops/nms.py` (reference
`lib/nms/nms.py`); the port keeps its own copy because that module
imports jax. COCO sigmas per `lib/nms/nms.py:77`.
"""

from __future__ import annotations

import numpy as np

COCO_SIGMAS = np.array([
    0.26, 0.25, 0.25, 0.35, 0.35, 0.79, 0.79, 0.72, 0.72,
    0.62, 0.62, 1.07, 1.07, 0.87, 0.87, 0.89, 0.89,
]) / 10.0


def oks_iou_np(g, d, a_g, a_d, sigmas=None, in_vis_thre=None) -> np.ndarray:
    """OKS between one keypoint vector g (3J,) and rows of d (N, 3J)."""
    if sigmas is None:
        sigmas = COCO_SIGMAS
    variances = (sigmas * 2) ** 2
    xg, yg = g[0::3], g[1::3]
    ious = np.zeros(d.shape[0])
    for i in range(d.shape[0]):
        xd, yd, vd = d[i, 0::3], d[i, 1::3], d[i, 2::3]
        e = ((xd - xg) ** 2 + (yd - yg) ** 2) / variances / (
            (a_g + a_d[i]) / 2 + np.spacing(1)
        ) / 2
        if in_vis_thre is not None:
            # reference quirk (`lib/nms/nms.py:91`): `list(vg > t) and
            # list(vd > t)` evaluates to the second list, so only d's
            # visibility masks
            e = e[vd > in_vis_thre]
        ious[i] = np.sum(np.exp(-e)) / e.shape[0] if e.shape[0] != 0 else 0.0
    return ious


def oks_nms_np(kpts, scores, areas, thresh, sigmas=None, in_vis_thre=None):
    """Greedy OKS NMS. kpts: (N, 3J) flat keypoints. Returns kept indices."""
    if len(kpts) == 0:
        return []
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        ious = oks_iou_np(kpts[i], kpts[order[1:]], areas[i],
                          areas[order[1:]], sigmas, in_vis_thre)
        order = order[1:][ious <= thresh]
    return keep


def soft_oks_nms_np(kpts, scores, areas, thresh, sigmas=None,
                    in_vis_thre=None, max_dets=20):
    """Gaussian soft OKS NMS (`lib/nms/nms.py:138-177`)."""
    if len(kpts) == 0:
        return []
    order = scores.argsort()[::-1]
    scores = scores[order].copy()
    keep = []
    while order.size > 0 and len(keep) < max_dets:
        i = order[0]
        ious = oks_iou_np(kpts[i], kpts[order[1:]], areas[i],
                          areas[order[1:]], sigmas, in_vis_thre)
        order = order[1:]
        scores = scores[1:] * np.exp(-(ious**2) / thresh)
        resort = scores.argsort()[::-1]
        order = order[resort]
        scores = scores[resort]
        keep.append(int(i))
    return keep
