"""Self-contained COCO keypoint evaluation (OKS-based AP/AR).

The port's copy of `advmix_tpu/evaluation/cocoeval_np.py` (which takes its
sigmas from a module that imports jax). pycocotools is not a dependency,
so this module implements
the COCOeval 'keypoints' protocol from its published specification
(cocodataset.org/#keypoints-eval): OKS similarity with the standard 17-joint
sigmas, greedy per-image matching sorted by detection score across OKS
thresholds 0.50:0.05:0.95, 101-point interpolated precision, area ranges
all/medium(32^2-96^2)/large(96^2+), maxDets=20. The reference calls
pycocotools at `lib/dataset/coco.py:441-454`; the stats vector layout
(AP, AP.5, AP.75, AP(M), AP(L), AR, AR.5, AR.75, AR(M), AR(L)) is
preserved.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List

import numpy as np

from ..ops.nms import COCO_SIGMAS

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.00, 101)
MAX_DETS = 20
AREA_RNGS = {
    "all": (0.0, 1e10),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}

STATS_NAMES = [
    "AP", "Ap .5", "AP .75", "AP (M)", "AP (L)",
    "AR", "AR .5", "AR .75", "AR (M)", "AR (L)",
]


def _dt_area(kps: np.ndarray) -> float:
    """Detection 'area' as pycocotools loadRes computes it for keypoint
    results: bounding box of the predicted keypoints (all 17, regardless of
    score)."""
    x = kps[0::3]
    y = kps[1::3]
    x0, x1 = x.min(), x.max()
    y0, y1 = y.min(), y.max()
    return float((x1 - x0) * (y1 - y0))


def compute_oks(dts: List[dict], gts: List[dict], sigmas=None) -> np.ndarray:
    """OKS matrix (D, G) for one image. dts sorted by caller."""
    if sigmas is None:
        sigmas = COCO_SIGMAS
    variances = (np.asarray(sigmas) * 2) ** 2
    k = len(sigmas)
    ious = np.zeros((len(dts), len(gts)))
    for j, gt in enumerate(gts):
        g = np.asarray(gt["keypoints"], dtype=np.float64)
        xg, yg, vg = g[0::3], g[1::3], g[2::3]
        k1 = int(np.count_nonzero(vg > 0))
        bb = gt["bbox"]
        x0, x1 = bb[0] - bb[2], bb[0] + bb[2] * 2
        y0, y1 = bb[1] - bb[3], bb[1] + bb[3] * 2
        for i, dt in enumerate(dts):
            d = np.asarray(dt["keypoints"], dtype=np.float64)
            xd, yd = d[0::3], d[1::3]
            if k1 > 0:
                dx = xd - xg
                dy = yd - yg
            else:
                z = np.zeros(k)
                dx = np.maximum(z, x0 - xd) + np.maximum(z, xd - x1)
                dy = np.maximum(z, y0 - yd) + np.maximum(z, yd - y1)
            e = (dx**2 + dy**2) / variances / (
                gt["area"] + np.spacing(1)
            ) / 2.0
            if k1 > 0:
                e = e[vg > 0]
            ious[i, j] = np.sum(np.exp(-e)) / e.shape[0]
    return ious


class COCOKeypointEval:
    """Evaluate keypoint detections against GT annotations.

    gt: parsed person_keypoints json dict (images + annotations), or a path.
    dt: list of result dicts {image_id, keypoints (3J list), score}.
    """

    def __init__(self, gt, dt: List[dict], sigmas=None):
        if isinstance(gt, str):
            with open(gt) as f:
                gt = json.load(f)
        self.sigmas = np.asarray(sigmas if sigmas is not None else COCO_SIGMAS)

        self.img_ids = sorted({im["id"] for im in gt["images"]})
        self.gts: Dict[int, List[dict]] = defaultdict(list)
        for ann in gt.get("annotations", []):
            if ann.get("category_id", 1) != 1:
                continue
            g = dict(ann)
            vg = np.asarray(g["keypoints"][2::3])
            g["num_keypoints"] = g.get(
                "num_keypoints", int(np.count_nonzero(vg > 0))
            )
            g["ignore"] = bool(g.get("iscrowd", 0)) or g["num_keypoints"] == 0
            self.gts[g["image_id"]].append(g)

        self.dts: Dict[int, List[dict]] = defaultdict(list)
        for det in dt:
            d = dict(det)
            d["area"] = _dt_area(np.asarray(d["keypoints"], dtype=np.float64))
            self.dts[d["image_id"]].append(d)

        self.stats = None

    # -- matching ------------------------------------------------------------

    def _evaluate_img(self, img_id, area_rng, ious_full):
        gts = self.gts.get(img_id, [])
        dts = self.dts.get(img_id, [])
        if len(gts) == 0 and len(dts) == 0:
            return None

        for g in gts:
            g["_ignore"] = g["ignore"] or (
                g["area"] < area_rng[0] or g["area"] > area_rng[1]
            )
        gtind = np.argsort([g["_ignore"] for g in gts], kind="mergesort")
        gts = [gts[i] for i in gtind]
        dtind = np.argsort([-d["score"] for d in dts], kind="mergesort")
        dts = [dts[i] for i in dtind[:MAX_DETS]]
        iscrowd = [int(g.get("iscrowd", 0)) for g in gts]

        ious = (
            ious_full[:, gtind] if len(ious_full) > 0 else ious_full
        )

        T = len(IOU_THRS)
        G, D = len(gts), len(dts)
        gtm = np.zeros((T, G))
        dtm = np.zeros((T, D))
        gt_ig = np.array([g["_ignore"] for g in gts])
        dt_ig = np.zeros((T, D))
        if len(ious) > 0:
            for tind, t in enumerate(IOU_THRS):
                for dind, d in enumerate(dts):
                    iou = min(t, 1 - 1e-10)
                    m = -1
                    for gind in range(G):
                        if gtm[tind, gind] > 0 and not iscrowd[gind]:
                            continue
                        if m > -1 and gt_ig[m] == 0 and gt_ig[gind] == 1:
                            break
                        if ious[dind, gind] < iou:
                            continue
                        iou = ious[dind, gind]
                        m = gind
                    if m == -1:
                        continue
                    dt_ig[tind, dind] = gt_ig[m]
                    dtm[tind, dind] = m + 1
                    gtm[tind, m] = dind + 1
        a = np.array(
            [
                d["area"] < area_rng[0] or d["area"] > area_rng[1]
                for d in dts
            ]
        ).reshape((1, D))
        dt_ig = np.logical_or(
            dt_ig, np.logical_and(dtm == 0, np.repeat(a, T, 0))
        )
        return {
            "dtMatches": dtm,
            "dtScores": [d["score"] for d in dts],
            "gtIgnore": gt_ig,
            "dtIgnore": dt_ig,
        }

    def evaluate(self):
        # OKS per image with dts sorted by score desc, truncated to maxDets
        self._ious = {}
        for img_id in self.img_ids:
            gts = self.gts.get(img_id, [])
            dts = sorted(
                self.dts.get(img_id, []), key=lambda d: -d["score"]
            )[:MAX_DETS]
            if len(gts) == 0 or len(dts) == 0:
                self._ious[img_id] = np.zeros((len(dts), len(gts)))
            else:
                self._ious[img_id] = compute_oks(dts, gts, self.sigmas)

        self._eval_imgs = {
            a: [
                self._evaluate_img(img_id, rng, self._ious[img_id])
                for img_id in self.img_ids
            ]
            for a, rng in AREA_RNGS.items()
        }

    # -- accumulation --------------------------------------------------------

    def accumulate(self):
        T, R, A = len(IOU_THRS), len(REC_THRS), len(AREA_RNGS)
        precision = -np.ones((T, R, A))
        recall = -np.ones((T, A))

        for aind, a in enumerate(AREA_RNGS):
            results = [e for e in self._eval_imgs[a] if e is not None]
            if not results:
                continue
            dt_scores = np.concatenate([e["dtScores"] for e in results])
            inds = np.argsort(-dt_scores, kind="mergesort")
            dtm = np.concatenate([e["dtMatches"] for e in results], axis=1)[
                :, inds
            ]
            dt_ig = np.concatenate([e["dtIgnore"] for e in results], axis=1)[
                :, inds
            ]
            gt_ig = np.concatenate([e["gtIgnore"] for e in results])
            npig = int(np.count_nonzero(gt_ig == 0))
            if npig == 0:
                continue
            tps = np.logical_and(dtm, np.logical_not(dt_ig))
            fps = np.logical_and(
                np.logical_not(dtm), np.logical_not(dt_ig)
            )
            tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
            fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
            for t in range(T):
                tp, fp = tp_sum[t], fp_sum[t]
                nd = len(tp)
                rc = tp / npig
                pr = tp / (fp + tp + np.spacing(1))
                recall[t, aind] = rc[-1] if nd else 0
                pr = pr.tolist()
                for i in range(nd - 1, 0, -1):
                    if pr[i] > pr[i - 1]:
                        pr[i - 1] = pr[i]
                inds_r = np.searchsorted(rc, REC_THRS, side="left")
                q = np.zeros(R)
                for ri, pi in enumerate(inds_r):
                    if pi < nd:
                        q[ri] = pr[pi]
                precision[t, :, aind] = q

        self._precision = precision
        self._recall = recall

    def summarize(self):
        def _summ(ap: bool, iou_thr=None, area="all"):
            aind = list(AREA_RNGS).index(area)
            if ap:
                s = self._precision[:, :, aind]
            else:
                s = self._recall[:, aind]
            if iou_thr is not None:
                t = int(np.where(np.isclose(IOU_THRS, iou_thr))[0][0])
                s = s[t : t + 1]
            s = s[s > -1]
            return float(np.mean(s)) if s.size else -1.0

        self.stats = np.array(
            [
                _summ(True),
                _summ(True, 0.5),
                _summ(True, 0.75),
                _summ(True, area="medium"),
                _summ(True, area="large"),
                _summ(False),
                _summ(False, 0.5),
                _summ(False, 0.75),
                _summ(False, area="medium"),
                _summ(False, area="large"),
            ]
        )
        return self.stats

    def run(self):
        self.evaluate()
        self.accumulate()
        return self.summarize()
