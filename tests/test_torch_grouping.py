"""The port's AE grouping (`advmix_tpu_torch/evaluation/grouping.py`)
against the JAX package's and against the loop-faithful oracle of the
published HigherHRNet `match_by_tag` (tests/grouping_oracle.py), on the
randomized and adversarial fixtures of tests/test_grouping_oracle.py:
exact cost ties, key collisions, detection storms past max_people, T=2
first-component ties, every joint order, and ignore_too_much.

All three run float64 numpy and scipy on the same inputs: people must be
equal to the bit (the oracle's arrays to atol 1e-6, as its own test holds
the JAX package). `parse_bottomup` (grouping, the refinement from the
maps, the quarter-pixel adjustment and the scores) is held to the JAX
package's on seeded maps with scalar and T=2 tags, also equal to the bit.
"""

import numpy as np
import pytest

from advmix_tpu.evaluation import grouping as jax_grouping
from advmix_tpu_torch.evaluation import grouping

from grouping_oracle import match_by_tag
from test_grouping_oracle import _random_fixture


def _random_cases():
    cases = []
    for tdim, seed in ((1, 0), (2, 1)):
        rng = np.random.RandomState(seed)
        for case in range(30):
            num_joints = int(rng.choice([4, 9, 17]))
            k = int(rng.randint(3, 9))
            num_people = int(rng.randint(0, 5))
            x, y, val, tag = _random_fixture(rng, num_joints, k, tdim,
                                             num_people)
            order = (grouping.COCO_JOINT_ORDER if num_joints == 17
                     else list(range(num_joints)))
            max_people = int(rng.choice([2, 5, 30]))
            cases.append((f"random_t{tdim}_{case}", x, y, val, tag, order,
                          dict(max_people=max_people)))
    return cases


def _storm_cases():
    rng = np.random.RandomState(7)
    cases = []
    for case in range(20):
        x, y, val, tag = _random_fixture(rng, 6, 12, 2, num_people=2)
        cases.append((f"many_detections_{case}", x, y, np.maximum(val, 0.2),
                      tag, list(range(6)), dict(max_people=3)))
    return cases


def _adversarial_cases():
    cases = []
    # three groups at rounding-equivalent tag distances, equal scores
    j, k = 4, 3
    tag = np.zeros((j, k, 1))
    tag[0, :, 0] = [0.0, 1.0, 2.0]
    tag[1:, :, 0] = [0.5, 1.5, 0.5]
    cases.append(("exact_rounded_tie",
                  np.tile(np.arange(k, dtype=np.float64) * 10, (j, 1)),
                  np.tile(np.arange(k, dtype=np.float64) * 7, (j, 1)),
                  np.full((j, k), 0.5), tag, list(range(j)), {}))
    # a seed whose tag[0] collides with a group's key joins that group
    tag = np.zeros((3, 2, 1))
    tag[0, :, 0] = [1.0, 9.0]
    tag[1, :, 0] = [1.0, 30.0]
    tag[2, :, 0] = [5.0, 5.0]
    cases.append(("key_collision",
                  np.array([[0.0, 50.0], [5.0, 60.0], [9.0, 70.0]]),
                  np.array([[0.0, 40.0], [5.0, 50.0], [9.0, 60.0]]),
                  np.full((3, 2), 0.9), tag, [0, 1, 2],
                  dict(tag_thresh=0.5)))
    # 40 detections per joint against max_people=5
    rng = np.random.RandomState(42)
    cases.append(("detection_storm", rng.uniform(0, 128, (5, 40)),
                  rng.uniform(0, 96, (5, 40)), rng.uniform(0.3, 1.0, (5, 40)),
                  rng.uniform(-8, 8, (5, 40, 1)), list(range(5)),
                  dict(max_people=5)))
    # T=2 tags whose first components all tie
    rng = np.random.RandomState(9)
    tag = np.zeros((4, 3, 2))
    tag[..., 0] = 2.0
    tag[0, :, 1] = [0.0, 4.0, 8.0]
    tag[1:, :, 1] = [0.1, 4.1, 7.9]
    cases.append(("t2_first_component_ties", rng.uniform(0, 64, (4, 3)),
                  rng.uniform(0, 64, (4, 3)), np.full((4, 3), 0.8), tag,
                  list(range(4)), {}))
    # every joint order of one fixture
    rng = np.random.RandomState(17)
    x, y, val, tag = _random_fixture(rng, 6, 6, 1, num_people=3)
    for seed in range(6):
        cases.append((f"joint_order_{seed}", x, y, np.maximum(val, 0.25), tag,
                      list(np.random.RandomState(seed).permutation(6)),
                      dict(max_people=4)))
    # the ignore_too_much arm
    rng = np.random.RandomState(3)
    x, y, val, tag = _random_fixture(rng, 5, 8, 1, num_people=4)
    cases.append(("ignore_too_much", x, y, np.maximum(val, 0.3), tag,
                  list(range(5)), dict(max_people=2, ignore_too_much=True)))
    return cases


CASES = _random_cases() + _storm_cases() + _adversarial_cases()


@pytest.mark.parametrize("name,x,y,val,tag,order,kw", CASES,
                         ids=[c[0] for c in CASES])
def test_group_peaks_matches_jax_and_oracle(name, x, y, val, tag, order, kw):
    kw = dict(dict(detection_thresh=0.1, tag_thresh=1.0, max_people=30), **kw)
    peaks = {"x": x, "y": y, "val": val,
             "tag": tag[..., 0] if tag.shape[-1] == 1 and "t1" in name
             else tag}
    got = grouping.group_peaks(peaks, joint_order=order, **kw)
    want = jax_grouping.group_peaks(peaks, joint_order=order, **kw)
    np.testing.assert_array_equal(got, want)
    oracle = match_by_tag(
        tag, np.stack([x, y], axis=2), val, order,
        detection_threshold=kw["detection_thresh"],
        tag_threshold=kw["tag_thresh"], max_num_people=kw["max_people"],
        ignore_too_much=kw.get("ignore_too_much", False))
    assert got.shape == oracle.shape
    np.testing.assert_allclose(got, oracle, rtol=0, atol=1e-6)


def test_storm_seeds_past_max_people_and_collisions_merge():
    """The two published quirks really occur in the fixtures above."""
    by_name = {c[0]: c for c in CASES}
    _, x, y, val, tag, order, kw = by_name["detection_storm"]
    got = grouping.group_peaks({"x": x, "y": y, "val": val, "tag": tag},
                               joint_order=order, **kw)
    assert got.shape[0] > 5  # seeding is uncapped
    _, x, y, val, tag, order, kw = by_name["key_collision"]
    got = grouping.group_peaks({"x": x, "y": y, "val": val, "tag": tag},
                               joint_order=order, **kw)
    assert got.shape[0] < 6  # a colliding seed joined a group


def _maps(rng, tdim, h=24, w=20, j=17, k=30, people=4):
    """Heatmaps with a few Gaussian people, their tag maps (a constant
    tag per person around its joints, noise elsewhere), and the top-k
    peaks of the maps (numpy, as the device step gives them)."""
    yy, xx = np.mgrid[0:h, 0:w]
    heat = 0.05 * rng.rand(h, w, j)
    tags = rng.randn(h, w, j, tdim) * 3.0
    for p in range(people):
        ptag = rng.uniform(-4, 4, tdim)
        for jj in range(j):
            if rng.rand() < 0.2:
                continue
            cx, cy = rng.uniform(1, w - 2), rng.uniform(1, h - 2)
            heat[..., jj] = np.maximum(heat[..., jj], rng.uniform(0.3, 1.0) *
                                       np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2)
                                              / 4.0))
            near = (xx - cx) ** 2 + (yy - cy) ** 2 < 6
            tags[near, jj] = ptag + 0.1 * rng.randn(int(near.sum()), tdim)
    flat = heat.transpose(2, 0, 1).reshape(j, -1)
    idx = np.argsort(-flat, axis=1, kind="stable")[:, :k]
    tag_flat = tags.transpose(2, 0, 1, 3).reshape(j, h * w, tdim)
    peaks = {"x": (idx % w).astype(np.float32),
             "y": (idx // w).astype(np.float32),
             "val": np.take_along_axis(flat, idx, 1),
             "tag": np.take_along_axis(tag_flat, idx[..., None], 1)}
    if tdim == 1:
        tags, peaks["tag"] = tags[..., 0], peaks["tag"][..., 0]
    return heat, tags, peaks


@pytest.mark.parametrize("tdim", [1, 2])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_parse_bottomup_matches_jax(tdim, seed):
    heat, tags, peaks = _maps(np.random.RandomState(seed), tdim)
    people, scores = grouping.parse_bottomup(heat, tags, peaks)
    want_people, want_scores = jax_grouping.parse_bottomup(heat, tags, peaks)
    assert len(people) >= 4  # grouping, refinement and adjustment all ran
    np.testing.assert_array_equal(people, want_people)
    np.testing.assert_array_equal(scores, want_scores)


def test_parse_bottomup_without_detections():
    heat = np.zeros((8, 8, 17))
    peaks = {"x": np.zeros((17, 4)), "y": np.zeros((17, 4)),
             "val": np.zeros((17, 4)), "tag": np.zeros((17, 4, 2))}
    people, scores = grouping.parse_bottomup(heat, np.zeros((8, 8, 17, 2)),
                                             peaks)
    assert people.shape == (0, 17, 5) and scores.shape == (0,)
