"""Greedy associative-embedding grouping (host side, numpy + scipy).

The port's copy of `advmix_tpu/evaluation/grouping.py`, a loop-faithful
form of the published HigherHRNet parser (`match_by_tag`, official
lib/core/group.py): per joint in a fixed order, detections are matched to
the existing person groups by TAG-VECTOR distance through a minimum-cost
assignment with the published `round(dist) * 100 - score` cost, the cost
matrix padded square with 1e10 where detections outnumber groups, pairs
written in row order; a detection that fails the assignment or the tag
threshold seeds a new group (uncapped: only the list of match candidates
is cut to max_people), and a seed whose first tag component equals an
existing group's key joins that group and resets its tag list.

Tags are vectors (J, k, T): under the flip test the eval step stacks the
unflipped and flipped-back tagmaps as T=2 and the distance is the L2 norm
over T; scalar (J, k) tags are T=1. The device gives the per-joint top-k
peak tensors (`ops/ae.py:top_k_peaks`); this module takes numpy copies,
and maps in the JAX layout: heatmaps (H, W, J), tags (H, W, J[, T]) (a
transposed view of the port's (J, H, W[, T]) maps is enough).
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment

# HigherHRNet's COCO-17 processing order: stable joints (nose, eyes, ears,
# shoulders, hips) seed person groups before the noisier limb extremities.
COCO_JOINT_ORDER = [0, 1, 2, 3, 4, 5, 6, 11, 12, 7, 8, 9, 10, 13, 14, 15, 16]


def _peak_tags(peaks: dict) -> np.ndarray:
    """(J, k) scalar or (J, k, T) vector tags -> (J, k, T)."""
    tag = np.asarray(peaks["tag"])
    return tag[..., None] if tag.ndim == 2 else tag


def group_peaks(
    peaks: dict,  # numpy arrays: x, y, val (J, k); tag (J, k[, T])
    detection_thresh: float = 0.1,
    tag_thresh: float = 1.0,
    max_people: int = 30,
    joint_order=None,
    ignore_too_much: bool = False,
    use_detection_val: bool = True,
):
    """Returns (P, J, 3+T) arrays [x, y, val, tag...] for P grouped people
    (insertion order, exactly the published joint_dict semantics)."""
    tag_k = _peak_tags(peaks)
    num_joints, k, tdim = tag_k.shape
    if joint_order is None:
        joint_order = (
            COCO_JOINT_ORDER if num_joints == 17 else list(range(num_joints))
        )

    groups = []  # each: dict(joints=(J, 3+T) array, tags=[tag vectors])
    # the published joint_dict is keyed by the SEED tag's first component:
    # a later seed whose tag[0] collides with an existing group's key joins
    # THAT group (setdefault) and RESETS its tag list (tag_dict[key] = [tag])
    # instead of creating a new person — measure-zero for continuous tags,
    # but exact-parity fixtures exercise it (tests/test_grouping_oracle.py)
    by_key = {}

    def _seed(j, det):
        key = float(det[3])
        if key in by_key:
            g = by_key[key]
            g["joints"][j] = det
            g["tags"] = [det[3:]]
        else:
            g = {"joints": np.zeros((num_joints, 3 + tdim), np.float32),
                 "tags": [det[3:]]}
            g["joints"][j] = det
            by_key[key] = g
            groups.append(g)

    for j in joint_order:
        vals = peaks["val"][j]
        sel = vals > detection_thresh
        if not np.any(sel):
            continue
        dets = np.concatenate(
            [
                np.stack([peaks["x"][j][sel], peaks["y"][j][sel],
                          vals[sel]], axis=1),
                tag_k[j][sel],
            ],
            axis=1,
        )  # (D, 3+T)

        if not groups:
            for d in dets:
                _seed(j, d)
            continue

        # only the first max_people groups are match candidates (published)
        cand = groups[:max_people]
        if ignore_too_much and len(cand) == max_people:
            continue
        group_tags = np.stack(
            [np.mean(g["tags"], axis=0) for g in cand]
        )  # (P, T)
        diff = np.linalg.norm(
            dets[:, None, 3:] - group_tags[None, :, :], ord=2, axis=2
        )  # (D, P)
        if use_detection_val:
            # cost favors low tag distance and high detection score
            cost = np.round(diff) * 100 - dets[:, 2][:, None]
        else:
            cost = diff.copy()
        n_det, n_grp = cost.shape
        if n_det > n_grp:
            # published formulation: pad to square with 1e10 dummy columns
            # rather than solving the rectangular problem — the round()'d
            # cost has exact ties, and tie-breaking must match the
            # published matrix for assignment parity
            cost = np.concatenate(
                [cost, np.full((n_det, n_det - n_grp), 1e10)], axis=1
            )
        rows, cols = linear_sum_assignment(cost)
        # every detection row gets exactly one pair (the matrix is padded
        # square when detections outnumber groups, rectangular-with-slack
        # otherwise); process pairs in row order, join-or-seed per row —
        # the published loop's write ORDER, which is observable when key
        # collisions make several writes land in the same group
        for r, c in zip(rows, cols):
            if c < n_grp and diff[r, c] < tag_thresh:
                cand[c]["joints"][j] = dets[r]
                cand[c]["tags"].append(dets[r, 3:])
            else:
                # unmatched or over-threshold detections seed NEW groups,
                # uncapped — the published else-branch (key collisions
                # join the colliding group, see _seed)
                _seed(j, dets[r])

    if not groups:
        return np.zeros((0, num_joints, 3 + tdim), np.float32)
    return np.stack([g["joints"] for g in groups])


def refine_group(
    joints: np.ndarray,  # (J, 3+T)
    heatmaps: np.ndarray,  # (H, W, J)
    tags: np.ndarray,  # (H, W, J) or (H, W, J, T)
):
    """Fill missing joints from the heatmap penalized by tag distance
    (HigherHRNet's refine step, vector-tag form)."""
    if tags.ndim == 3:
        tags = tags[..., None]
    h, w, num_joints, tdim = tags.shape
    seen = joints[:, 2] > 0
    if not np.any(seen):
        return joints
    person_tag = np.mean(joints[seen, 3:], axis=0)  # (T,)
    out = joints.copy()
    for j in range(num_joints):
        if joints[j, 2] > 0:
            continue
        dist = np.linalg.norm(
            tags[:, :, j, :] - person_tag[None, None, :], ord=2, axis=2
        )
        score = heatmaps[:, :, j] - np.round(dist)
        yy, xx = np.unravel_index(np.argmax(score), (h, w))
        val = heatmaps[yy, xx, j]
        if val > 0:
            out[j, 0], out[j, 1], out[j, 2] = xx, yy, val
            out[j, 3:] = person_tag
    return out


def quarter_offset_np(coords_xy: np.ndarray, heatmap: np.ndarray):
    """Quarter-pixel refinement toward the larger neighbor (numpy, one
    joint map). coords_xy: (2,) [x, y]."""
    h, w = heatmap.shape
    px, py = int(coords_xy[0]), int(coords_xy[1])
    x, y = float(coords_xy[0]), float(coords_xy[1])
    if 1 < px < w - 1 and 1 < py < h - 1:
        x += 0.25 * np.sign(heatmap[py, px + 1] - heatmap[py, px - 1])
        y += 0.25 * np.sign(heatmap[py + 1, px] - heatmap[py - 1, px])
    return np.array([x, y])


def parse_bottomup(
    heatmaps: np.ndarray,  # (H, W, J) aggregated
    tags: np.ndarray,  # (H, W, J) or (H, W, J, T)
    peaks: dict,  # (J, k[, T]) numpy peak tensors from the device
    detection_thresh: float = 0.1,
    tag_thresh: float = 1.0,
    max_people: int = 30,
    refine: bool = True,
    adjust: bool = True,
):
    """Full parse: group -> refine -> sub-pixel adjust -> scores.

    Returns (people (P, J, 3+T) in heatmap coords, scores (P,))."""
    people = group_peaks(peaks, detection_thresh, tag_thresh, max_people)
    if refine:
        people = np.stack(
            [refine_group(p, heatmaps, tags) for p in people]
        ) if len(people) else people
    if adjust and len(people):
        for p in people:
            for j in range(people.shape[1]):
                if p[j, 2] > 0:
                    p[j, :2] = quarter_offset_np(p[j, :2], heatmaps[:, :, j])
    if not len(people):
        return people, np.zeros((0,), np.float32)
    scores = np.array([
        p[p[:, 2] > 0, 2].mean() if np.any(p[:, 2] > 0) else 0.0
        for p in people
    ])
    return people, scores
