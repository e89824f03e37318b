"""The port's bottom-up steps and validation against the JAX package's, and
the bottom-up entry points on the CPU.

A tiny HigherHRNet (tests/test_torch_higher_hrnet.py, one block per
branch) in float64 on both sides, seeded weights with calibrated BN, SGD
with distinct learning rates for D and G, ALPHA 0.3 and ADV_W 0.7 as in
tests/test_torch_train_steps.py, and
batches of 2 images of 3 people with a valid mask of blocks (aligned so
that no resized pixel sits at the 0.5 tie, where the two packages'
rounding may differ; tests/test_torch_ae.py):

- `make_bottomup_step`, two iterations: loss, pull and push within 1e-9
  of their magnitude, the updated parameters and BN statistics within
  1e-9;
- `make_bottomup_advmix_step`, two iterations: loss_d and loss_g within
  1e-9 of their magnitude, D (with its BN statistics) and G within 1e-9;
  the teacher never moves;
- the eval step with flip and TEST.SCALE_FACTOR [1] and [0.5, 1, 2]: heat
  and tags within 1e-9 of their largest magnitude, the peaks' positions
  equal and their values and tags within 1e-9;
- `validate_bottomup` on a tiny COCO tree, given the JAX eval step's maps:
  the results json equal to the bit and the same AP (the port's own maps
  then change the greedy grouping of a few percent of the groups: see the
  test);
- the train (plain and AdvMix), validate and sweep CLIs with `--device cpu`
  on a tiny bottom-up YAML written by the test.
"""

import csv
import json
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from jax import enable_x64

from advmix_tpu.config import load_config as jax_load_config
from advmix_tpu.data import Loader as JaxLoader
from advmix_tpu.data import build_dataset as jax_build_dataset
from advmix_tpu.engine import steps as jax_steps
from advmix_tpu.engine import trainer as jax_trainer
from advmix_tpu.engine.state import AdvMixState as JaxAdvMixState
from advmix_tpu.engine.state import PoseState as JaxPoseState
from advmix_tpu.models.unet import UnetGenerator as JaxUnet
from advmix_tpu.parallel import get_mesh
from advmix_tpu_torch.config import load_config
from advmix_tpu_torch.data import Loader, build_dataset
from advmix_tpu_torch.engine import steps, trainer
from advmix_tpu_torch.engine.state import AdvMixState, PoseState, \
    make_teacher
from advmix_tpu_torch.models import get_pose_net
from advmix_tpu_torch.models.convert import jax_to_torch_state_dict, \
    jax_unet_to_torch_state_dict, torch_to_jax_leaves
from advmix_tpu_torch.models.unet import UnetGenerator
from advmix_tpu_torch.tools import test_corruption as sweep_tool
from advmix_tpu_torch.tools import train as train_tool
from advmix_tpu_torch.tools import validate as validate_tool

from test_torch_bottomup_data import write_bottomup_coco
from test_torch_higher_hrnet import (SHALLOW, SIZE, higher_cfg, jax_higher,
                                     seeded_higher)
from torch_port_util import random_variables, unflatten

torch.set_num_threads(2)

B, M, J = 2, 3, 5
ALPHA, ADV_W = 0.3, 0.7
LR_D, LR_G = 0.01, 0.02
NGF, DOWNS = 8, 4
TOL = 1e-9


def _leaves(tree, coll):
    flat = flax.traverse_util.flatten_dict(flax.core.unfreeze(tree))
    return {f"{coll}/{k[-2]}/{k[-1]}": np.asarray(v) for k, v in flat.items()}


def _max_diff(got: dict, want: dict) -> float:
    assert set(got) == set(want) and got
    return max(float(np.abs(got[k] - want[k]).max()) for k in want)


def _short(flat: dict) -> dict:
    return {f"{k.split('/')[0]}/" + "/".join(k.split("/")[-2:]): v
            for k, v in flat.items()}


def block_mask(rng, b=B, size=SIZE):
    """0/1 valid masks of blocks on a grid of 4: no pixel of their 2x or
    4x antialiased shrink is a 0.5 tie."""
    mask = np.ones((b, size, size))
    for i in range(b):
        y, x = rng.randint(0, size // 4 - 4, 2) * 4
        hh, ww = rng.randint(2, 5, 2) * 4
        mask[i, y:y + hh, x:x + ww] = 0
    return mask


def make_batches(seed=5, n=2, views=False):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        vis = (rng.rand(B, M, J) > 0.25).astype(np.float64)
        vis[1, 2] = 0.0  # a padded person slot
        out.append(dict(
            image=rng.randn(B, SIZE, SIZE, 9 if views else 3),
            joints=rng.uniform(2, SIZE - 2, (B, M, J, 2)),
            joints_vis=vis, mask=block_mask(rng)))
    return out


def _jax_batch(b, key):
    return {key: jnp.asarray(b["image"]), "joints": jnp.asarray(b["joints"]),
            "joints_vis": jnp.asarray(b["joints_vis"]),
            "mask": jnp.asarray(b["mask"])}


def _port_batch(b, key):
    return {key: torch.from_numpy(np.ascontiguousarray(
                b["image"].transpose(0, 3, 1, 2))),
            "joints": torch.from_numpy(b["joints"]),
            "joints_vis": torch.from_numpy(b["joints_vis"]),
            "mask": torch.from_numpy(b["mask"])}


def _flat64(seed):
    _, flat = seeded_higher(seed, extra=SHALLOW)
    return {k: v.astype(np.float64) for k, v in flat.items()}


def _close(got, ref):
    return abs(got - ref) < TOL * max(1.0, abs(ref))


def _port_d(flat):
    model = get_pose_net(higher_cfg(extra=SHALLOW)).double()
    model.load_state_dict(jax_to_torch_state_dict(flat, model), strict=True)
    return model


def test_mask_blocks_have_no_ties():
    """The batches' masks resize identically in both packages."""
    mask = make_batches()[0]["mask"]
    for hw in ((16, 16), (32, 32)):
        want = np.asarray(jax_steps._mask_at(jnp.asarray(mask), *hw))
        got = steps._mask_at(torch.from_numpy(mask), *hw).numpy()
        np.testing.assert_array_equal(got, want)
        assert 0 < got.mean() < 1


@pytest.fixture(scope="module")
def plain_run():
    flat = _flat64(11)
    batches = make_batches()
    with enable_x64(True):
        jcfg = higher_cfg(jax_load_config, extra=SHALLOW)
        v = unflatten(flat)
        tx = optax.sgd(LR_D)
        state = JaxPoseState(params=v["params"], batch_stats=v["batch_stats"],
                             opt_state=tx.init(v["params"]),
                             step=jnp.zeros((), jnp.int32))
        step = jax_steps.make_bottomup_step(
            jax_higher(dtype=jnp.float64, extra=SHALLOW), tx, jcfg,
            get_mesh(1))
        metrics = []
        for b in batches:
            state, m = step(state, _jax_batch(b, "image"))
            metrics.append({k: float(x) for k, x in m.items()})
        want = _leaves(state.params, "params")
        want.update(_leaves(state.batch_stats, "batch_stats"))
    return flat, batches, want, metrics


def test_plain_step_matches_jax(plain_run):
    flat, batches, want, want_m = plain_run
    d = _port_d(flat)
    state = PoseState(d, torch.optim.SGD(d.parameters(), lr=LR_D))
    step = steps.make_bottomup_step(state, higher_cfg(extra=SHALLOW))
    for b, ref in zip(batches, want_m):
        got = {k: float(x) for k, x in step(_port_batch(b, "image")).items()}
        assert set(got) == set(ref) == {"loss", "pull", "push", "acc",
                                        "acc_cnt"}
        assert ref["pull"] > 0 and ref["push"] > 0
        for k in ref:
            assert _close(got[k], ref[k]), (k, got[k], ref[k])
    assert state.step == 2
    assert _max_diff(_short(flat), want) > 1e-4  # the run moved D
    assert _max_diff(torch_to_jax_leaves(d), want) < TOL


@pytest.fixture(scope="module")
def advmix_run():
    flat_d, flat_t = _flat64(11), _flat64(23)
    batches = make_batches(seed=7, views=True)
    with enable_x64(True):
        jg = JaxUnet(input_nc=9, num_downs=DOWNS, ngf=NGF, dtype=jnp.float64)
        gshapes = jax.eval_shape(lambda: jg.init(
            jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 9))))
        gshapes = {"/".join(k): v for k, v in flax.traverse_util.flatten_dict(
            flax.core.unfreeze(gshapes)).items()}
        flat_g = {k: v.astype(np.float64)
                  for k, v in random_variables(gshapes, 37).items()}
        vd, vt = unflatten(flat_d), unflatten(flat_t)
        pg = unflatten(flat_g)["params"]
        tx_d, tx_g = optax.sgd(LR_D), optax.sgd(LR_G)
        state = JaxAdvMixState(
            params_d=vd["params"], batch_stats_d=vd["batch_stats"],
            opt_state_d=tx_d.init(vd["params"]), params_g=pg,
            opt_state_g=tx_g.init(pg), params_t=vt["params"],
            batch_stats_t=vt["batch_stats"], step=jnp.zeros((), jnp.int32))
        step = jax_steps.make_bottomup_advmix_step(
            jax_higher(dtype=jnp.float64, extra=SHALLOW), jg, tx_d, tx_g,
            higher_cfg(jax_load_config, extra=SHALLOW), get_mesh(1),
            alpha=ALPHA, adv_loss_weight=ADV_W)
        metrics = []
        for b in batches:
            state, m = step(state, _jax_batch(b, "views"))
            metrics.append({k: float(x) for k, x in m.items()})
        want_d = _leaves(state.params_d, "params")
        want_d.update(_leaves(state.batch_stats_d, "batch_stats"))
        want_g = _leaves(state.params_g, "params")
    return (flat_d, flat_t, flat_g), batches, (want_d, want_g, metrics)


def test_advmix_step_matches_jax(advmix_run):
    (flat_d, flat_t, flat_g), batches, (want_d, want_g, want_m) = advmix_run
    d = _port_d(flat_d)
    g = UnetGenerator(input_nc=9, num_downs=DOWNS, ngf=NGF)
    g.load_state_dict(jax_unet_to_torch_state_dict(flat_g, g))
    g = g.double()
    teacher = make_teacher(_port_d(flat_t), torch.float64)
    state = AdvMixState(d, torch.optim.SGD(d.parameters(), lr=LR_D), g,
                        torch.optim.SGD(g.parameters(), lr=LR_G), teacher)
    step = steps.make_bottomup_advmix_step(
        state, higher_cfg(extra=SHALLOW), alpha=ALPHA, adv_loss_weight=ADV_W)
    for b, ref in zip(batches, want_m):
        got = {k: float(x) for k, x in step(_port_batch(b, "views")).items()}
        assert set(got) == set(ref) == {"loss_d", "loss_g", "acc", "acc_cnt"}
        for k in ref:
            assert _close(got[k], ref[k]), (k, got[k], ref[k])
    assert _max_diff(_short(flat_d), want_d) > 1e-4
    assert _max_diff(torch_to_jax_leaves(d), want_d) < TOL
    assert _max_diff(torch_to_jax_leaves(g), want_g) < TOL
    # D ran in train mode twice per iteration; the teacher never moved
    tracked = [v for k, v in d.state_dict().items()
               if k.endswith("num_batches_tracked")]
    assert tracked and all(int(t) == 4 for t in tracked)
    assert _max_diff(torch_to_jax_leaves(teacher), _short(flat_t)) == 0.0


@pytest.mark.parametrize("scales", [(1.0,), (0.5, 1.0, 2.0)])
def test_eval_step_flip_and_scales_match_jax(scales):
    model, flat = seeded_higher(seed=3)
    model = model.double()
    x = np.random.RandomState(8).randn(2, SIZE, SIZE, 3)
    pairs = [[1, 2], [3, 4]]
    with enable_x64(True):
        jcfg = higher_cfg(jax_load_config)
        v = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                         unflatten(flat))
        step = jax_steps.make_bottomup_eval_step(
            jax_higher(dtype=jnp.float64), jcfg, pairs, get_mesh(1),
            scales=scales)
        heat_j, tags_j, peaks_j = jax.device_get(step(
            v["params"], v["batch_stats"], {"image": jnp.asarray(x)}))
    cfg = higher_cfg()
    assert cfg.TEST.FLIP_TEST
    heat, tags, peaks = steps.make_bottomup_eval_step(
        model, cfg, pairs, scales=scales)({"image": torch.from_numpy(x)})
    assert tuple(tags.shape) == (2, J, 32, 32, 2)  # flip-stacked, NCHW+T
    np.testing.assert_allclose(heat.numpy(), heat_j.transpose(0, 3, 1, 2),
                               rtol=0, atol=TOL * np.abs(heat_j).max())
    np.testing.assert_allclose(tags.numpy(),
                               tags_j.transpose(0, 3, 1, 2, 4), rtol=0,
                               atol=TOL * np.abs(tags_j).max())
    # the peaks pass the detection threshold, then run into exact-0 ties
    assert float(peaks["val"].max()) > 0.1 and float(peaks["val"].min()) == 0
    for k in ("x", "y"):
        np.testing.assert_array_equal(peaks[k].numpy(), peaks_j[k])
    for k in ("val", "tag"):
        np.testing.assert_allclose(peaks[k].numpy(), peaks_j[k], rtol=0,
                                   atol=TOL * np.abs(peaks_j[k]).max())


# ---------------------------------------------------------------------------
# validate_bottomup and the entry points
# ---------------------------------------------------------------------------

VAL_SIZES = [(96, 80), (64, 120), (100, 100)]


@pytest.fixture(scope="module")
def coco_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bu"))
    rng = np.random.RandomState(0)
    for s in ("train2017", "val2017"):
        write_bottomup_coco(root, s, VAL_SIZES, rng)
    return root


def _bu_cfg(load, root):
    cfg = higher_cfg(load, joints=17)
    cfg.defrost()
    cfg.DATASET.DATASET = "bottomup_coco"
    cfg.DATASET.ROOT = root
    cfg.DATASET.TEST_SET = "val2017"
    cfg.freeze()
    return cfg


def test_validate_bottomup_matches_jax(coco_tree, tmp_path):
    """Given the same maps, the port's `validate_bottomup` writes the JAX
    package's results json to the bit, and the same AP. The maps are the
    JAX eval step's (float64), fed through the port's loop: on these dense
    random maps (~250 groups per image) a 1e-14 difference in a tag flips
    the greedy grouping of a few groups, so the port's own step (held to
    the JAX step within 1e-9 above) is run end to end after it, its group
    count within 3% of the JAX pass's."""
    model, flat = seeded_higher(seed=4, joints=17)
    cfg = _bu_cfg(load_config, coco_tree)
    ds = build_dataset(cfg, is_train=False)
    with enable_x64(True):
        jcfg = _bu_cfg(jax_load_config, coco_tree)
        jds = jax_build_dataset(jcfg, is_train=False)
        v = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                         unflatten(flat))
        mesh = get_mesh(1)
        jstep = jax_steps.make_bottomup_eval_step(
            jax_higher(joints=17, dtype=jnp.float64), jcfg, jds.flip_pairs,
            mesh)
        jnames, jap = jax_trainer.validate_bottomup(
            jcfg, jstep, v["params"], v["batch_stats"], jds,
            JaxLoader(jds, 2), mesh, str(tmp_path / "jax"))

        def jax_maps(batch):
            heat, tags, peaks = jax.device_get(jstep(
                v["params"], v["batch_stats"],
                {"image": jnp.asarray(batch["image"].numpy())}))
            return (torch.tensor(heat.transpose(0, 3, 1, 2)),
                    torch.tensor(tags.transpose(0, 3, 1, 2, 4)),
                    {k: torch.tensor(np.asarray(a))
                     for k, a in peaks.items()})

        stats = {}
        names, ap = trainer.validate_bottomup(
            cfg, jax_maps, ds, Loader(ds, 2, num_threads=1),
            str(tmp_path / "port"), torch.device("cpu"), stats=stats)
    assert stats["images"] == len(VAL_SIZES) and stats["groups"] > 0
    assert dict(names) == dict(jnames) and ap == jap
    rel = os.path.join("results", "keypoints_val2017_results_bu.json")
    got = json.load(open(tmp_path / "port" / rel))
    assert got == json.load(open(tmp_path / "jax" / rel))
    assert len(got) == stats["groups"]

    own = {}
    _, own_ap = trainer.validate_bottomup(
        cfg, steps.make_bottomup_eval_step(model.double(), cfg,
                                           ds.flip_pairs), ds,
        Loader(ds, 2, num_threads=1), str(tmp_path / "own"),
        torch.device("cpu"), stats=own)
    assert np.isfinite(own_ap) and own["images"] == len(VAL_SIZES)
    assert abs(own["groups"] - stats["groups"]) <= 0.03 * stats["groups"]


def _write_yaml(path, root, **over):
    tiny = {k: (dict(v) if isinstance(v, dict) else v)
            for k, v in higher_cfg(joints=17).MODEL.EXTRA.items()}
    doc = dict(
        DATASET=dict(DATASET="bottomup_coco", ROOT=root,
                     TRAIN_SET="train2017", TEST_SET="val2017", FLIP=True,
                     ROT_FACTOR=30, SCALE_FACTOR=0.25),
        MODEL=dict(NAME="pose_higher_hrnet", IMAGE_SIZE=[SIZE, SIZE],
                   HEATMAP_SIZE=[SIZE // 4, SIZE // 4], SIGMA=2,
                   NUM_JOINTS=17, TAG_PER_JOINT=True, INIT_WEIGHTS=False,
                   EXTRA=tiny),
        TRAIN=dict(BATCH_SIZE_PER_GPU=2, END_EPOCH=1, OPTIMIZER="adam",
                   LR=0.0015),
        TEST=dict(BATCH_SIZE_PER_GPU=2, FLIP_TEST=True),
        PRINT_FREQ=1)
    for k, v in over.items():
        doc[k].update(v)
    with open(path, "w") as f:
        yaml.safe_dump(doc, f)
    return str(path)


@pytest.mark.parametrize("mode", ["plain", "advmix"])
def test_train_cli_bottomup(coco_tree, tmp_path, monkeypatch, mode):
    monkeypatch.chdir(tmp_path)
    cfg_path = _write_yaml(tmp_path / "bu.yaml", coco_tree)
    flags = (["--advmix", "--sample_times", "3", "--downsamples", "4"]
             if mode == "advmix" else [])
    out = train_tool.main(["--cfg", cfg_path, "--device", "cpu", *flags])
    # batches of 2, the last partial one dropped
    assert len(out["history"]) == 1
    assert len(out["history"][0]) == len(VAL_SIZES) // 2
    key = "loss_d" if mode == "advmix" else "loss"
    for m in out["history"][0]:
        assert np.isfinite(m[key]) and m[key] > 0
    if mode == "advmix":
        assert all(m["loss_g"] < 0 for m in out["history"][0])
    assert np.isfinite(out["perf"])
    assert os.path.isfile(out["final_state"])
    res = os.path.join(out["output_dir"], "results",
                       "keypoints_val2017_results_bu.json")
    assert os.path.isfile(res)
    # the validate entry point reads the final state, with multi-scale
    names, perf = validate_tool.main([
        "--cfg", cfg_path, "--device", "cpu", "TEST.MODEL_FILE",
        out["final_state"], "TEST.SCALE_FACTOR", "[0.5, 1, 2]"])
    assert "AP" in names and np.isfinite(perf)


def test_train_cli_rejects_top_down_only_options(coco_tree, tmp_path,
                                                 monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg_path = _write_yaml(tmp_path / "bu.yaml", coco_tree)
    with pytest.raises(SystemExit, match="--random_corruption"):
        train_tool.main(["--cfg", cfg_path, "--device", "cpu",
                         "--random_corruption"])
    assert os.listdir(tmp_path) == ["bu.yaml"]  # it stopped before writing


def test_sweep_cli_bottomup(coco_tree, tmp_path, monkeypatch):
    """The on-the-fly sweep over the clean pass and one corruption x 5
    severities: robust_C.val gets a line per pass, the CSV its columns,
    and the clean pass equals a direct `validate_bottomup`."""
    monkeypatch.chdir(tmp_path)
    cfg_path = _write_yaml(tmp_path / "bu.yaml", coco_tree)
    model, _ = seeded_higher(seed=4, joints=17)
    torch.save(model.state_dict(), tmp_path / "start.pth")
    result = sweep_tool.main([
        "--cfg", cfg_path, "--device", "cpu", "--on_the_fly",
        "--distortions", "zoom_blur", "--exp_id", "bu",
        "TEST.MODEL_FILE", str(tmp_path / "start.pth")])
    runs = result["runs"]
    assert [(c, s) for c, s, _, _ in runs] == [("clean", 0)] + [
        ("zoom_blur", s) for s in range(5)]
    lines = open(os.path.join(result["output_dir"],
                              "robust_C.val")).read().splitlines()
    assert len(lines) == 6 and lines[0].startswith("clean_0:")
    with open(result["csv"]) as f:
        row = next(csv.DictReader(f))
    assert list(row) == ["clean_mAP", "mean_corrupted_mAP", "rAP",
                         "zoom_blur"]
    cfg = _bu_cfg(load_config, coco_tree)
    ds = build_dataset(cfg, is_train=False)
    model = model.eval()
    _, ap = trainer.validate_bottomup(
        cfg, steps.make_bottomup_eval_step(model, cfg, ds.flip_pairs), ds,
        Loader(ds, 2), str(tmp_path / "direct"), torch.device("cpu"))
    assert runs[0][3] == pytest.approx(ap, abs=1e-12)
