"""MPII in the port against the JAX package: the records of
`load_mpii_records`, `MPIIDataset`'s samples, PCKh by `evaluate_mpii_pckh`
on a `gt_valid.mat` written by `scipy.io.savemat`, zip archives, and the
sweep entry point on MPII (`python -m advmix_tpu_torch.tools.test_corruption
--device cpu`) against the JAX package's `validate` with the JAX sweep's
prep, on the fly and on an `mpii-C` tree that the port's renderer writes.

Tolerances: records, samples and zip pixels equal; PCKh name/values within
1e-12 (the same numpy arithmetic); the sweep's per-pass PCKh Mean equal and
its CSV equal byte for byte, with each pass's saved predictions (pred.mat)
within 1e-3 px of the JAX package's (f32 heatmaps and inverse affine, as
test_torch_validate.py holds COCO keypoints).
"""

import glob
import json
import os
import subprocess
import sys
import zipfile

import cv2
import numpy as np
import pytest
import scipy.io as sio
import yaml

from advmix_tpu.config import load_config as jax_load_config
from advmix_tpu.data import Loader as JaxLoader
from advmix_tpu.data import build_dataset as jax_build_dataset
from advmix_tpu.data.records import load_mpii_records as jax_load_mpii
from advmix_tpu.engine import steps as jax_steps
from advmix_tpu.engine import trainer as jax_trainer
from advmix_tpu.evaluation.mpii_eval import evaluate_mpii_pckh as jax_pckh
from advmix_tpu.parallel import get_mesh
from advmix_tpu.parallel.mesh import replicate
from advmix_tpu.utils import zipreader as jax_zipreader
from advmix_tpu_torch.config import load_config
from advmix_tpu_torch.data import MPIIDataset, build_dataset
from advmix_tpu_torch.data.records import load_mpii_records
from advmix_tpu_torch.evaluation.mpii_eval import evaluate_mpii_pckh
from advmix_tpu_torch.models import get_pose_net
from advmix_tpu_torch.tools import make_datasets
from advmix_tpu_torch.utils import zipreader

from test_torch_sweep import jax_prep
from torch_port_util import (TINY_EXTRA, TINY_HEATMAP, TINY_IMAGE,
                             calibrate_bn, jax_hrnet, random_variables,
                             unflatten, variable_shapes)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOINT_NAMES = ["rank", "rkne", "rhip", "lhip", "lkne", "lank", "pelvis",
               "thorax", "upper neck", "head", "rwri", "relb", "rsho",
               "lsho", "lelb", "lwri"]
N_PEOPLE, J = 6, 16


def write_mpii(root, rng, n=N_PEOPLE, noisy=True, sets=("valid",)):
    """annot/<set>.json of n people, one 480x640 JPEG each (seeded noise
    with white joint markers), and annot/gt_valid.mat with some joints
    missing, as the MPII release lays them out."""
    os.makedirs(os.path.join(root, "annot"), exist_ok=True)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    anno = []
    gt_pos = np.zeros((J, 2, n))
    headboxes = np.zeros((2, 2, n))
    missing = np.zeros((J, n))
    for i in range(n):
        img = (rng.randint(0, 256, (480, 640, 3)) if noisy
               else np.full((480, 640, 3), 100)).astype(np.uint8)
        joints = np.stack([rng.uniform(200, 440, J),
                           rng.uniform(120, 360, J)], axis=1)
        vis = (rng.rand(J) > 0.15).astype(int)
        for x, y in joints:
            cv2.circle(img, (int(x), int(y)), 3, (255, 255, 255), -1)
        name = f"{i:09d}.jpg"
        cv2.imwrite(os.path.join(root, "images", name), img)
        center = joints.mean(0)
        anno.append(dict(image=name, center=[float(center[0]),
                                             float(center[1])],
                         scale=float(rng.uniform(1.0, 1.4)),
                         joints=[[float(a), float(b)] for a, b in joints],
                         joints_vis=[int(v) for v in vis]))
        gt_pos[:, :, i] = joints + 1.0  # the mat is 1-based
        missing[:, i] = 1 - vis
        half = rng.uniform(60, 100)
        headboxes[:, :, i] = [[center[0] - half, center[1] - half],
                              [center[0] + half, center[1] + half]]
    for s in sets:
        with open(os.path.join(root, "annot", f"{s}.json"), "w") as f:
            json.dump(anno, f)
    dataset_joints = np.zeros((1, J), object)
    for k, nm in enumerate(JOINT_NAMES):
        dataset_joints[0, k] = nm
    sio.savemat(os.path.join(root, "annot", "gt_valid.mat"),
                dict(dataset_joints=dataset_joints, jnt_missing=missing,
                     pos_gt_src=gt_pos, headboxes_src=headboxes))
    return anno, gt_pos - 1.0


@pytest.fixture(scope="module")
def mpii(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mpii") / "mpii")
    anno, gt = write_mpii(root, np.random.RandomState(3),
                          sets=("valid", "train", "test"))
    return root, anno, gt


def _cfg(load, root, **over):
    cfg = load()
    cfg.defrost()
    cfg.DATASET.DATASET = "mpii"
    cfg.DATASET.ROOT = root
    cfg.DATASET.TEST_SET = "valid"
    cfg.DATASET.TRAIN_SET = "train"
    cfg.MODEL.NUM_JOINTS = 16
    cfg.MODEL.IMAGE_SIZE = [64, 64]
    cfg.MODEL.HEATMAP_SIZE = [16, 16]
    for k, v in over.items():
        node = cfg
        *parts, leaf = k.split(".")
        for p in parts:
            node = node[p]
        node[leaf] = v
    cfg.freeze()
    return cfg


def _same_records(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k


@pytest.mark.parametrize("image_set,corruption,image_dir", [
    ("valid", "", "images"),
    ("train", "", "images"),
    ("test", "", "images"),
    ("valid", "fog", "images"),
    ("valid", "clean", "images.zip@"),
])
def test_mpii_records_equal_jax(mpii, image_set, corruption, image_dir):
    root = mpii[0]
    kw = dict(corruption_type=corruption, severity=2, root_c="data/mpii-C",
              image_dir_name=image_dir)
    got = load_mpii_records(root, image_set, 16, **kw)
    want = jax_load_mpii(root, image_set, 16, **kw)
    _same_records(got, want)
    # center and scale: +15*s on y, *1.25, then 1-based -> 0-based
    a = mpii[1][0]
    assert got[0]["center"][1] == np.float32(
        np.float64(a["center"][1]) + 15 * a["scale"] - 1)
    if corruption == "fog":
        assert got[0]["image"].startswith(
            os.path.join("data/mpii-C", "fog", "2"))


def _sample_keys(s):
    return {k: v for k, v in s.items() if k != "instance_index"}


@pytest.mark.parametrize("is_train", [False, True])
def test_mpii_dataset_samples_equal_jax(mpii, is_train):
    """Eval crops, and training samples with the half-body, scale,
    rotation and flip draws, equal the JAX package's for the same
    RandomState; the device-warp path's too."""
    root = mpii[0]
    over = {"DATASET.PROB_HALF_BODY": 1.0, "DATASET.NUM_JOINTS_HALF_BODY": 3}
    ds = build_dataset(_cfg(load_config, root, **over), is_train)
    jds = jax_build_dataset(_cfg(jax_load_config, root, **over), is_train)
    assert isinstance(ds, MPIIDataset) and len(ds) == N_PEOPLE
    for attr in ("flip_pairs", "parent_ids", "upper_body_ids",
                 "lower_body_ids", "num_joints"):
        assert getattr(ds, attr) == getattr(jds, attr), attr
    _same_records(ds.records, jds.records)
    for i in range(len(ds)):
        for raw in (False, True):
            fn = "get_raw_sample" if raw else "get_sample"
            got = getattr(ds, fn)(i, np.random.RandomState(10 + i))
            want = getattr(jds, fn)(i, np.random.RandomState(10 + i))
            want = _sample_keys(want)
            assert got.keys() == want.keys()
            for k in got:
                np.testing.assert_array_equal(np.asarray(got[k]),
                                              np.asarray(want[k]), err_msg=k)


def test_select_data_on_mpii_train(mpii):
    root = mpii[0]
    got = build_dataset(_cfg(load_config, root,
                             **{"DATASET.SELECT_DATA": True}), True)
    want = jax_build_dataset(_cfg(jax_load_config, root,
                                  **{"DATASET.SELECT_DATA": True}), True)
    _same_records(got.records, want.records)


def _pckh_cases(gt, rng):
    exact = gt.transpose(2, 0, 1).copy()  # (N, J, 2), 0-based
    off = exact + rng.randn(*exact.shape) * 50.0
    return {"exact": exact, "off": off,
            "far": exact + 500.0}


@pytest.mark.parametrize("case", ["exact", "off", "far"])
@pytest.mark.parametrize("robust", [False, True])
def test_pckh_equals_jax(mpii, tmp_path, case, robust):
    root, _, gt = mpii
    preds = _pckh_cases(gt, np.random.RandomState(4))[case]
    preds = np.concatenate([preds, np.ones(preds.shape[:2] + (1,))], -1)
    over = {"TEST.TEST_ROBUST": robust, "TEST.CORRUPTION_TYPE": "snow",
            "TEST.SEVERITY": 3}
    cfg = _cfg(load_config, root, **over)
    jcfg = _cfg(jax_load_config, root, **over)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    nv, mean = evaluate_mpii_pckh(cfg, None, preds, str(tmp_path / "port"))
    jnv, jmean = jax_pckh(jcfg, None, preds, str(tmp_path / "jax"))
    assert list(nv) == list(jnv) == ["Head", "Shoulder", "Elbow", "Wrist",
                                     "Hip", "Knee", "Ankle", "Mean",
                                     "Mean@0.1"]
    for k in nv:
        assert abs(nv[k] - jnv[k]) <= 1e-12, k
    assert mean == nv["Mean"] and abs(mean - jmean) <= 1e-12
    if case == "exact":
        assert mean == 100.0
    elif case == "off":
        assert 0.0 < mean < 100.0  # neither all hits nor all misses
    else:
        assert mean == 0.0
    name = "snow_3_pred.mat" if robust else "pred.mat"
    saved = sio.loadmat(str(tmp_path / "port" / name))["preds"]
    np.testing.assert_array_equal(
        saved, sio.loadmat(str(tmp_path / "jax" / name))["preds"])
    np.testing.assert_array_equal(saved, preds[:, :, :2] + 1.0)


def test_pckh_test_set_writes_preds_only(mpii, tmp_path):
    root = mpii[0]
    cfg = _cfg(load_config, root, **{"DATASET.TEST_SET": "test"})
    preds = np.zeros((N_PEOPLE, J, 3))
    assert evaluate_mpii_pckh(cfg, None, preds, str(tmp_path)) == (
        {"Null": 0.0}, 0.0)
    assert (tmp_path / "pred.mat").is_file()


def _zip_images(root):
    with zipfile.ZipFile(os.path.join(root, "images.zip"), "w") as z:
        for name in sorted(os.listdir(os.path.join(root, "images"))):
            z.write(os.path.join(root, "images", name), name)


@pytest.mark.parametrize("color_rgb", [False, True])
def test_zip_reads_equal_directory_reads(mpii, color_rgb):
    """DATA_FORMAT zip: the same JPEG's pixels from `images.zip@` as from
    the directory, through the dataset, byte for byte; the zip reader
    equals the JAX package's."""
    root = mpii[0]
    if not os.path.isfile(os.path.join(root, "images.zip")):
        _zip_images(root)
    over = {"DATASET.COLOR_RGB": color_rgb}
    plain = build_dataset(_cfg(load_config, root, **over), False)
    zipped = build_dataset(_cfg(load_config, root, **over,
                                **{"DATASET.DATA_FORMAT": "zip"}), False)
    for rp, rz in zip(plain.records, zipped.records):
        assert rz["image"] == os.path.join(
            root, "images.zip@", os.path.basename(rp["image"]))
        a, b = plain._read_image(rp["image"]), zipped._read_image(rz["image"])
        assert a.dtype == b.dtype == np.uint8 and np.array_equal(a, b)
        np.testing.assert_array_equal(zipreader.imread(rz["image"]),
                                      jax_zipreader.imread(rz["image"]))
    got = zipped.get_sample(0, np.random.RandomState(0))
    want = plain.get_sample(0, np.random.RandomState(0))
    np.testing.assert_array_equal(got["image"], want["image"])
    assert zipreader.split_zip_path("a/b.zip@/c/d.jpg") == ("a/b.zip",
                                                           "c/d.jpg")


def test_coco_zip_image_dir(tmp_path):
    """COCO's zip layout: `<ROOT>/<set>.zip@<file>`, as the JAX package
    builds it."""
    from advmix_tpu_torch.data import COCODataset
    from test_torch_validate import _coco_tree

    root = str(tmp_path / "coco")
    _coco_tree(root)
    with zipfile.ZipFile(os.path.join(root, "val2017.zip"), "w") as z:
        for name in sorted(os.listdir(os.path.join(root, "val2017"))):
            z.write(os.path.join(root, "val2017", name), name)
    cfgs = []
    for load in (load_config, jax_load_config):
        cfg = load()
        cfg.defrost()
        cfg.DATASET.ROOT = root
        cfg.DATASET.DATA_FORMAT = "zip"
        cfg.DATASET.DATASET = "coco"
        cfg.DATASET.TEST_SET = "val2017"
        cfg.TEST.USE_GT_BBOX = True
        cfg.freeze()
        cfgs.append(cfg)
    ds = COCODataset(cfgs[0], False)
    jds = jax_build_dataset(cfgs[1], False)
    assert [r["image"] for r in ds.records] == [r["image"]
                                               for r in jds.records]
    assert ds.records[0]["image"].startswith(os.path.join(root,
                                                          "val2017.zip@"))
    img = ds._read_image(ds.records[0]["image"])
    assert np.array_equal(img, cv2.imread(os.path.join(
        root, "val2017", os.path.basename(ds.records[0]["image"]))))


# ---------------------------------------------------------------------------
# the sweep on MPII
# ---------------------------------------------------------------------------

# key-free types: the port and the JAX package draw from different
# generators, so a random corruption could not agree
ON_THE_FLY = ["contrast", "jpeg_compression"]
PRE_RENDERED = ["brightness"]


def _robust_rows(out_dir):
    """[(pass, {name: value})] of robust_C.val."""
    with open(os.path.join(out_dir, "robust_C.val")) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    out = []
    for ln in lines:
        fields = [kv.split(" = ") for kv in ln.split(":\t")[1].split("\t")
                  if kv]
        out.append((ln.split(":")[0], {k: float(v) for k, v in fields}))
    return out


def _run_sweep(cfg_path, cwd, *flags):
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "advmix_tpu_torch.tools.test_corruption",
         "--cfg", cfg_path, "--device", "cpu", *flags], cwd=str(cwd),
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "loaded model" in proc.stderr
    return proc


def test_mpii_sweep_matches_jax(tmp_path, monkeypatch):
    root = str(tmp_path / "mpii")
    write_mpii(root, np.random.RandomState(5))
    w, h = TINY_IMAGE
    jmodel = jax_hrnet(TINY_EXTRA, num_joints=16)
    cfg_yaml = dict(
        OUTPUT_DIR=str(tmp_path / "output"),
        DATASET=dict(DATASET="mpii", ROOT=root, TEST_SET="valid",
                     TRAIN_SET="train"),
        MODEL=dict(NAME="pose_hrnet", NUM_JOINTS=16, IMAGE_SIZE=TINY_IMAGE,
                   HEATMAP_SIZE=TINY_HEATMAP, EXTRA=TINY_EXTRA),
        TEST=dict(BATCH_SIZE_PER_GPU=4, FLIP_TEST=True, POST_PROCESS=True,
                  SHIFT_HEATMAP=True, USE_GT_BBOX=True,
                  MODEL_FILE=str(tmp_path / "w.npz")),
    )
    cfg_path = str(tmp_path / "tiny_mpii.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg_yaml, f)
    calib = np.random.RandomState(50).randn(4, h, w, 3).astype(np.float32)
    flat = calibrate_bn(random_variables(variable_shapes(jmodel, (h, w)),
                                         seed=51),
                        get_pose_net(load_config(cfg_path)), calib)
    np.savez(str(tmp_path / "w.npz"), **flat)

    jcfg = jax_load_config(cfg_path)
    mesh = get_mesh(1)
    v = unflatten(flat)
    params = replicate(v["params"], mesh)
    stats = replicate(v["batch_stats"], mesh)
    clean_ds = jax_build_dataset(jcfg, is_train=False)
    step = jax_steps.make_eval_step(jmodel, jcfg, clean_ds.flip_pairs, mesh)
    jax_out = str(tmp_path / "jax_out")
    os.makedirs(jax_out)

    def jax_pass(corruption, severity0, pre_rendered):
        cfg = jcfg.clone()
        cfg.defrost()
        cfg.TEST.TEST_ROBUST = True
        cfg.TEST.CORRUPTION_TYPE = corruption
        cfg.TEST.SEVERITY = severity0
        cfg.DATASET.ROOT_C = str(tmp_path / "data" / "mpii-C")
        cfg.freeze()
        ds = jax_build_dataset(cfg, is_train=False) if pre_rendered \
            else clean_ds
        prep = jax_prep(cfg, "clean" if pre_rendered else corruption,
                        severity0 + 1)
        name_values, perf = jax_trainer.validate(
            cfg, step, prep, params, stats, ds,
            JaxLoader(ds, 4, shuffle=False), mesh, jax_out)
        assert perf == name_values["Mean"]
        return dict(name_values)

    def check(passes, out_dir, pre_rendered):
        got = _robust_rows(out_dir)
        assert [p for p, _ in got] == [f"{c}_{s}" for c, s in passes]
        table = [jax_pass(c, s, pre_rendered) for c, s in passes]
        # robust_C.val prints each value with repr: the floats round-trip
        assert [nv for _, nv in got] == table
        want = [nv["Mean"] for nv in table]
        assert 0.0 < want[0] < 100.0  # a PCKh that can move either way
        for c, s in passes:
            name = f"{c}_{s}_pred.mat"
            p = sio.loadmat(os.path.join(out_dir, name))["preds"]
            q = sio.loadmat(os.path.join(jax_out, name))["preds"]
            np.testing.assert_allclose(p, q, rtol=0, atol=1e-3, err_msg=name)
        return want

    passes = [("clean", 0)] + [(n, s) for n in ON_THE_FLY for s in range(5)]
    _run_sweep(cfg_path, tmp_path, "--on_the_fly", "--distortions",
               ",".join(ON_THE_FLY))
    (out_dir,) = glob.glob(str(tmp_path / "output_robustness" / "mpii" /
                               "pose_hrnet" / "*"))
    want = check(passes, out_dir, False)
    assert len(set(want)) > 1  # the corruptions moved the score
    want_dir = tmp_path / "jax_csv"
    want_dir.mkdir()
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.syspath_prepend(os.path.join(ROOT, "tools"))
    from test_corruption import write_final_csv as jax_write_final_csv

    jax_write_final_csv(want, ON_THE_FLY, str(want_dir), "robust", "mpii")
    with open(os.path.join(out_dir, "robust.csv"), "rb") as f, \
            open(want_dir / "robust.csv", "rb") as g:
        got_csv = f.read()
        assert got_csv == g.read()
    assert got_csv.startswith(b"clean_mean,mean_corrupted_mean,rmean,")

    # the port's renderer writes an mpii-C tree, the sweep reads it
    monkeypatch.chdir(tmp_path)
    make_datasets.main(["--dataset_root", os.path.join(root, "images"),
                        "--out_root", "data", "--out_file", "mpii-C",
                        "--corruptions", ",".join(PRE_RENDERED),
                        "--batch", "4", "--device", "cpu"])
    os.remove(os.path.join(out_dir, "robust_C.val"))
    _run_sweep(cfg_path, tmp_path, "--distortions", ",".join(PRE_RENDERED))
    check([("clean", 0)] + [(n, s) for n in PRE_RENDERED for s in range(5)],
          out_dir, True)
