"""The gathered evaluation on two gloo ranks against one rank.

- `merge_prediction_shards` equals the JAX package's on random shards;
- `tools/validate.main --num_devices 2 --device cpu` on a tiny HRNet over a
  COCO tree of 8 people at 3 per rank (the second global batch leaves
  rank 1 a padded `_n == 0` batch) writes the results json of the
  one-rank pass byte for byte, with the same AP; likewise the bottom-up
  `validate_bottomup` on the narrowed HigherHRNet, at 1 image per rank;
- the on-the-fly sweep on two ranks writes the one-rank CSV and
  `robust_C.val` byte for byte;
- under `--random_corruption` the ranks draw different branches, and rank
  0 the branches of a one-rank run.

The one-rank runs go through `parallel.dist.launch` with one CPU device,
so both sides compute on one thread in a fresh process.
"""

import json
import os

import numpy as np
import pytest
import yaml

from advmix_tpu.engine.trainer import \
    merge_prediction_shards as jax_merge_prediction_shards
from advmix_tpu_torch.config import load_config
from advmix_tpu_torch.engine.trainer import merge_prediction_shards
from advmix_tpu_torch.models import get_pose_net
from advmix_tpu_torch.parallel.dist import launch
from advmix_tpu_torch.tools import test_corruption as sweep_tool
from advmix_tpu_torch.tools import validate as validate_tool

from test_torch_bottomup_data import write_bottomup_coco
from test_torch_bottomup_steps import VAL_SIZES, _write_yaml
from test_torch_higher_hrnet import seeded_higher
from test_torch_validate import _coco_tree
from torch_dist_worker import random_corruption_draws, rank_sys_path
from torch_port_util import (TINY_EXTRA, TINY_HEATMAP, TINY_IMAGE,
                             calibrate_bn, jax_hrnet, random_variables,
                             variable_shapes)


@pytest.fixture(scope="module", autouse=True)
def _rank_sys_path():
    with rank_sys_path():
        yield


def test_merge_prediction_shards_matches_jax():
    rng = np.random.RandomState(0)
    idx = rng.permutation(23)
    cuts = [0, 7, 7, 15, 23]  # one shard empty
    parts = [(idx[a:b], rng.randn(b - a, 17, 3).astype(np.float32),
              rng.randn(b - a, 6)) for a, b in zip(cuts, cuts[1:])]
    got, want = merge_prediction_shards(parts), \
        jax_merge_prediction_shards(parts)
    assert (got[0] == np.arange(23)).all()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def tiny_coco(tmp_path_factory):
    """A COCO tree of 4 images of 2 people and a tiny HRNet's YAML and
    seeded weights; TEST.BATCH_SIZE_PER_GPU 3."""
    tmp = tmp_path_factory.mktemp("dist_validate")
    coco = str(tmp / "coco")
    _coco_tree(coco)
    w, h = TINY_IMAGE
    cfg_path = str(tmp / "tiny.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(dict(
            DATASET=dict(DATASET="coco", ROOT=coco, TEST_SET="val2017",
                         COLOR_RGB=True),
            MODEL=dict(NAME="pose_hrnet", NUM_JOINTS=17,
                       IMAGE_SIZE=TINY_IMAGE, HEATMAP_SIZE=TINY_HEATMAP,
                       EXTRA=TINY_EXTRA),
            TEST=dict(BATCH_SIZE_PER_GPU=3, FLIP_TEST=True,
                      POST_PROCESS=True, SHIFT_HEATMAP=True,
                      USE_GT_BBOX=True, OKS_THRE=0.9, IN_VIS_THRE=0.2,
                      MODEL_FILE=str(tmp / "w.npz"))), f)
    flat = calibrate_bn(
        random_variables(variable_shapes(jax_hrnet(TINY_EXTRA), (h, w)),
                         seed=21),
        get_pose_net(load_config(cfg_path)),
        np.random.RandomState(20).randn(4, h, w, 3).astype(np.float32))
    np.savez(str(tmp / "w.npz"), **flat)
    return tmp, cfg_path


def _out_dir(output: str, model: str, dataset: str = "coco") -> str:
    return os.path.join(output + "_robustness", dataset, model,
                        "test_corruption")


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _one_and_two_ranks(main, argv, tmp, tag):
    """`main(argv)` on one launched rank and with --num_devices 2; returns
    both results and both output roots."""
    outs = [str(tmp / f"{tag}_{n}") for n in (1, 2)]
    one = launch(main, ["cpu"], argv + ["OUTPUT_DIR", outs[0]])
    two = main(argv + ["--num_devices", "2", "OUTPUT_DIR", outs[1]])
    return one, two, outs


def test_two_rank_validate_gives_one_rank_predictions(tiny_coco):
    tmp, cfg_path = tiny_coco
    (nv1, ap1), (nv2, ap2), outs = _one_and_two_ranks(
        validate_tool.main, ["--cfg", cfg_path, "--device", "cpu"], tmp,
        "validate")
    assert ap1 == ap2 and dict(nv1) == dict(nv2)
    res = os.path.join("results", "keypoints_val2017_results_0.json")
    got, want = (_read(os.path.join(_out_dir(o, "pose_hrnet"), res))
                 for o in outs[::-1])
    assert got == want and len(json.loads(want)) == 8
    assert _read(os.path.join(_out_dir(outs[1], "pose_hrnet"),
                              "robust_C.val")).count(b"clean_0") == 1


def test_two_rank_validate_bottomup_gives_one_rank_results(tmp_path):
    root = str(tmp_path / "bu")
    write_bottomup_coco(root, "val2017", VAL_SIZES, np.random.RandomState(0))
    np.savez(str(tmp_path / "w.npz"), **seeded_higher(seed=4, joints=17)[1])
    cfg_path = _write_yaml(tmp_path / "bu.yaml", root,
                           TEST=dict(BATCH_SIZE_PER_GPU=1,
                                     MODEL_FILE=str(tmp_path / "w.npz")))
    (nv1, ap1), (nv2, ap2), outs = _one_and_two_ranks(
        validate_tool.main, ["--cfg", cfg_path, "--device", "cpu"],
        tmp_path, "bottomup")
    assert ap1 == ap2 and dict(nv1) == dict(nv2)
    res = os.path.join("results", "keypoints_val2017_results_bu.json")
    got, want = (_read(os.path.join(
        _out_dir(o, "pose_higher_hrnet", "bottomup_coco"), res))
        for o in outs[::-1])
    assert got == want and len(json.loads(want)) > 10


def test_two_rank_sweep_writes_the_one_rank_csv(tiny_coco):
    tmp, cfg_path = tiny_coco
    one, two, outs = _one_and_two_ranks(
        sweep_tool.main, ["--cfg", cfg_path, "--device", "cpu",
                          "--on_the_fly", "--distortions", "contrast"],
        tmp, "sweep")
    assert [r[3] for r in one["runs"]] == [r[3] for r in two["runs"]]
    assert len(two["runs"]) == 6
    for name in ("robust.csv", "robust_C.val"):
        got, want = (_read(os.path.join(_out_dir(o, "pose_hrnet"), name))
                     for o in outs[::-1])
        assert got == want


def test_random_corruption_ranks_draw_their_own_branches():
    import torch

    (b0, x0), (b1, x1) = launch(random_corruption_draws, ["cpu", "cpu"],
                                1234)
    assert b0 != b1 and not np.array_equal(x0, x1)
    # rank 0 draws as a single rank does
    assert b0 == torch.randint(0, 75, (4,), generator=torch.Generator()
                               .manual_seed(1234)).tolist()
