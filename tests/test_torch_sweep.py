"""The port's sweep entry point, `python -m
advmix_tpu_torch.tools.test_corruption --device cpu`, against the JAX
package's `validate` with a prep that corrupts as the JAX sweep does
(`tools/test_corruption.py:112-125`), on a small JPEG COCO tree and the
same tiny-HRNet weights (an `.npz` the port reads through TEST.MODEL_FILE).

On the fly: clean + contrast, glass_blur and jpeg_compression at
severities 1..5 (16 passes). The tree's images are seeded noise, not flat
grey: glass_blur truncates a blurred image to uint8 and JPEG rounds DCT
coefficients, and on a flat region the blurred value sits 1 ulp from the
integer, so the last bit of a convolution would decide whole regions, on
either side. Every pass's AP must equal the JAX package's, and the CSV
must equal, byte for byte, the JAX package's `write_final_csv` of the JAX
results. Random weights score an AP near 0, so each pass's results json
is held to the JAX package's as well. Then the port's renderer (`tools/make_datasets.py`) writes a -C
tree of contrast and glass_blur, and the sweep without --on_the_fly reads
it: every pass's AP must equal the JAX package's `validate` on the same
files.

The robust demo's own config (PoseResNet-18 64x64 on the synthetic marker
set, PCK; `advmix_tpu_torch/scripts/advmix_demo.sh` sweeps it) on 32
samples, clean + contrast at severities 1..5, on the same weights through
an `.npz`: every pass's PCK must equal the JAX package's, each pass's
predictions within 1e-3 px of its, and the CSV must equal the JAX
`write_final_csv`'s byte for byte, which ties the demo's mPC and rPC to the
JAX package's arithmetic.
"""

import json
import os
import subprocess
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import yaml

from advmix_tpu.config import load_config as jax_load_config
from advmix_tpu.data import Loader as JaxLoader
from advmix_tpu.data import build_dataset as jax_build_dataset
from advmix_tpu.engine import steps as jax_steps
from advmix_tpu.engine import trainer as jax_trainer
from advmix_tpu.models import get_pose_net as jax_get_pose_net
from advmix_tpu.ops.augment import IMAGENET_MEAN_STD
from advmix_tpu.ops.corruptions import corrupt as jax_corrupt
from advmix_tpu.ops.heatmap import generate_target
from advmix_tpu.parallel import get_mesh
from advmix_tpu.parallel.mesh import replicate
from advmix_tpu_torch.config import load_config
from advmix_tpu_torch.data import build_dataset
from advmix_tpu_torch.models import get_pose_net
from advmix_tpu_torch.tools import make_datasets
from advmix_tpu_torch.tools import test_corruption as port_sweep

from test_torch_validate import _coco_tree
from torch_port_util import (TINY_EXTRA, TINY_HEATMAP, TINY_IMAGE,
                             calibrate_bn, jax_hrnet, random_variables,
                             unflatten, variable_shapes)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(ROOT, "experiments/synthetic/res18_64x64_robust_demo.yaml")
ON_THE_FLY = ["contrast", "glass_blur", "jpeg_compression"]
PRE_RENDERED = ["contrast", "glass_blur"]


def jax_prep(cfg, corruption, severity):
    """The JAX sweep's prep (`tools/test_corruption.py:112-125`)."""
    mean, std = IMAGENET_MEAN_STD
    image_size = tuple(cfg.MODEL.IMAGE_SIZE)
    heatmap_size = tuple(cfg.MODEL.HEATMAP_SIZE)

    @jax.jit
    def prep(image_u8, joints, joints_vis):
        img = image_u8.astype(jnp.float32)
        if corruption != "clean":
            img = corrupt_exact(img)
        target, _, tw = generate_target(joints, joints_vis, image_size,
                                        heatmap_size, float(cfg.MODEL.SIGMA))
        return {"image": (img - mean) / std, "target": target,
                "target_weight": tw}

    def corrupt_exact(img):
        return jax_corrupt(img, corruption, severity, jax.random.PRNGKey(1),
                           exact_render=True)

    return prep


def robust_aps(out_dir):
    with open(os.path.join(out_dir, "robust_C.val")) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    return [(ln.split(":")[0], float(ln.split("AP = ")[1].split("\t")[0]))
            for ln in lines]


def same_predictions(out_dir, jax_out, passes):
    """Random weights score an AP near 0 on every pass, so each pass's
    results json is held to the JAX package's too: equal image ids, scores
    within rtol 1e-4 and keypoints within 1e-3 px (as
    test_torch_validate.py holds the clean pass), and the corrupted passes
    must move the keypoints off the clean pass's."""
    def load(root, corruption, severity0):
        name = ("keypoints_val2017_results_0.json" if corruption == "clean"
                else f"keypoints_val2017_results_0_{corruption}_"
                     f"{severity0}.json")
        with open(os.path.join(root, "results", name)) as f:
            res = json.load(f)
        kpts = np.array([r["keypoints"] for r in res]).reshape(-1, 17, 3)
        return [r["image_id"] for r in res], [r["score"] for r in res], kpts

    clean = load(jax_out, "clean", 0)[2]
    for corruption, severity0 in passes:
        ids, scores, kpts = load(out_dir, corruption, severity0)
        want_ids, want_scores, want = load(jax_out, corruption, severity0)
        assert ids == want_ids
        np.testing.assert_allclose(scores, want_scores, rtol=1e-4,
                                   err_msg=f"{corruption}_{severity0}")
        np.testing.assert_allclose(kpts[..., :2], want[..., :2], rtol=0,
                                   atol=1e-3,
                                   err_msg=f"{corruption}_{severity0}")
        if corruption != "clean":
            assert np.abs(want[..., :2] - clean[..., :2]).max() > 1.0


def run_sweep(cfg_path, cwd, *flags):
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "advmix_tpu_torch.tools.test_corruption",
         "--cfg", cfg_path, "--device", "cpu", *flags], cwd=str(cwd),
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "loaded model" in proc.stderr
    return proc


def _noisy_tree(root):
    """`_coco_tree`'s annotations over seeded noise images."""
    _coco_tree(root)
    rng = np.random.RandomState(1)
    for name in sorted(os.listdir(os.path.join(root, "val2017"))):
        cv2.imwrite(os.path.join(root, "val2017", name),
                    rng.randint(0, 256, (480, 640, 3)).astype(np.uint8))


def test_sweep_entry_point_matches_jax(tmp_path, monkeypatch):
    coco = str(tmp_path / "coco")
    _noisy_tree(coco)
    w, h = TINY_IMAGE
    jmodel = jax_hrnet(TINY_EXTRA)
    calib = np.random.RandomState(30).randn(4, h, w, 3).astype(np.float32)
    cfg_yaml = dict(
        OUTPUT_DIR=str(tmp_path / "output"),
        DATASET=dict(DATASET="coco", ROOT=coco, TEST_SET="val2017",
                     COLOR_RGB=True),
        MODEL=dict(NAME="pose_hrnet", NUM_JOINTS=17, IMAGE_SIZE=TINY_IMAGE,
                   HEATMAP_SIZE=TINY_HEATMAP, EXTRA=TINY_EXTRA),
        TEST=dict(BATCH_SIZE_PER_GPU=4, FLIP_TEST=True, POST_PROCESS=True,
                  SHIFT_HEATMAP=True, USE_GT_BBOX=True, OKS_THRE=0.9,
                  IN_VIS_THRE=0.2, MODEL_FILE=str(tmp_path / "w.npz")),
    )
    cfg_path = str(tmp_path / "tiny.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg_yaml, f)
    flat = calibrate_bn(random_variables(variable_shapes(jmodel, (h, w)),
                                         seed=31),
                        get_pose_net(load_config(cfg_path)), calib)
    np.savez(str(tmp_path / "w.npz"), **flat)

    # the JAX package, in process, on a one-device mesh
    jcfg = jax_load_config(cfg_path)
    mesh = get_mesh(1)
    v = unflatten(flat)
    params = replicate(v["params"], mesh)
    stats = replicate(v["batch_stats"], mesh)
    clean_ds = jax_build_dataset(jcfg, is_train=False)
    step = jax_steps.make_eval_step(jmodel, jcfg, clean_ds.flip_pairs, mesh)

    def jax_pass(corruption, severity0, pre_rendered):
        cfg = jcfg.clone()
        cfg.defrost()
        cfg.TEST.TEST_ROBUST = True
        cfg.TEST.CORRUPTION_TYPE = corruption
        cfg.TEST.SEVERITY = severity0
        cfg.DATASET.ROOT_C = str(tmp_path / "data" / "coco-C")
        cfg.freeze()
        ds = jax_build_dataset(cfg, is_train=False) if pre_rendered \
            else clean_ds
        prep = jax_prep(cfg, "clean" if pre_rendered else corruption,
                        severity0 + 1)
        _, ap = jax_trainer.validate(
            cfg, step, prep, params, stats, ds, JaxLoader(ds, 4,
                                                          shuffle=False),
            mesh, str(tmp_path / "jax_out"))
        return ap

    passes = [("clean", 0)] + [(n, s) for n in ON_THE_FLY for s in range(5)]
    jax_aps = [jax_pass(c, s, False) for c, s in passes]

    run_sweep(cfg_path, tmp_path, "--on_the_fly", "--distortions",
              ",".join(ON_THE_FLY))
    out_dir = os.path.join(str(tmp_path / "output") + "_robustness", "coco",
                           "pose_hrnet", "test_corruption")
    got = robust_aps(out_dir)
    assert [p for p, _ in got] == [f"{c}_{s}" for c, s in passes]
    assert [ap for _, ap in got] == jax_aps
    same_predictions(out_dir, str(tmp_path / "jax_out"), passes)
    want_dir = tmp_path / "jax_csv"
    want_dir.mkdir()
    # the JAX sweep script sets a default compilation-cache directory when
    # imported: keep it inside this test
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.syspath_prepend(os.path.join(ROOT, "tools"))
    from test_corruption import write_final_csv as jax_write_final_csv

    jax_write_final_csv(jax_aps, ON_THE_FLY, str(want_dir), "robust", "coco")
    with open(os.path.join(out_dir, "robust.csv"), "rb") as f, \
            open(want_dir / "robust.csv", "rb") as g:
        assert f.read() == g.read()

    # the renderer writes a -C tree; the sweep reads it
    monkeypatch.chdir(tmp_path)
    make_datasets.main(["--dataset_root", os.path.join(coco, "val2017"),
                        "--out_root", "data", "--out_file", "coco-C",
                        "--corruptions", ",".join(PRE_RENDERED),
                        "--batch", "4", "--device", "cpu"])
    for name in PRE_RENDERED:
        for s in range(5):
            assert len(os.listdir(tmp_path / "data" / "coco-C" / name /
                                  str(s))) == 4
    os.remove(os.path.join(out_dir, "robust_C.val"))
    run_sweep(cfg_path, tmp_path, "--distortions", ",".join(PRE_RENDERED))
    passes = [("clean", 0)] + [(n, s) for n in PRE_RENDERED
                               for s in range(5)]
    got = robust_aps(out_dir)
    assert [p for p, _ in got] == [f"{c}_{s}" for c, s in passes]
    assert [ap for _, ap in got] == [jax_pass(c, s, True)
                                     for c, s in passes]
    same_predictions(out_dir, str(tmp_path / "jax_out"), passes)


def recording(dataset, preds: list):
    """`dataset`, whose evaluate() keeps a copy of the predictions it is
    given."""
    evaluate = dataset.evaluate

    def record(cfg, all_preds, *args, **kwargs):
        preds.append(np.array(all_preds))
        return evaluate(cfg, all_preds, *args, **kwargs)

    dataset.evaluate = record
    return dataset


def test_demo_config_sweep_matches_jax(tmp_path, monkeypatch):
    with open(DEMO) as f:
        cfg_yaml = yaml.safe_load(f)
    cfg_yaml["OUTPUT_DIR"] = str(tmp_path / "output")
    cfg_yaml["DATASET"]["SYNTH_LENGTH"] = 32
    cfg_yaml["TEST"]["MODEL_FILE"] = str(tmp_path / "w.npz")
    cfg_path = str(tmp_path / "demo.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg_yaml, f)
    jcfg = jax_load_config(cfg_path)
    jmodel = jax_get_pose_net(jcfg)
    calib = np.random.RandomState(40).randn(4, 64, 64, 3).astype(np.float32)
    flat = calibrate_bn(random_variables(variable_shapes(jmodel, (64, 64)),
                                         seed=41),
                        get_pose_net(load_config(cfg_path)), calib)
    np.savez(str(tmp_path / "w.npz"), **flat)

    mesh = get_mesh(1)
    v = unflatten(flat)
    params = replicate(v["params"], mesh)
    stats = replicate(v["batch_stats"], mesh)
    jax_preds = []
    clean_ds = recording(jax_build_dataset(jcfg, is_train=False), jax_preds)
    step = jax_steps.make_eval_step(jmodel, jcfg, clean_ds.flip_pairs, mesh)
    passes = [("clean", 0)] + [("contrast", s) for s in range(5)]
    jax_pcks = []
    for corruption, severity0 in passes:
        cfg = jcfg.clone()
        cfg.defrost()
        cfg.TEST.TEST_ROBUST = True
        cfg.TEST.CORRUPTION_TYPE = corruption
        cfg.TEST.SEVERITY = severity0
        cfg.freeze()
        _, pck = jax_trainer.validate(
            cfg, step, jax_prep(cfg, corruption, severity0 + 1), params,
            stats, clean_ds, JaxLoader(clean_ds, 32, shuffle=False), mesh,
            str(tmp_path / "jax_out"))
        jax_pcks.append(pck)

    port_preds = []
    out = port_sweep.main(
        ["--cfg", cfg_path, "--on_the_fly", "--distortions", "contrast",
         "--device", "cpu"],
        build_dataset=lambda cfg, is_train, image_set=None: recording(
            build_dataset(cfg, is_train, image_set), port_preds))
    assert [(c, s) for c, s, _, _ in out["runs"]] == passes
    assert [pck for _, _, _, pck in out["runs"]] == jax_pcks
    assert [list(nv) for _, _, nv, _ in out["runs"]] == [["PCK"]] * 6
    assert 0.0 < jax_pcks[0] < 1.0
    assert len(port_preds) == len(jax_preds) == len(passes)
    for (corruption, severity0), got, want in zip(passes, port_preds,
                                                  jax_preds):
        np.testing.assert_allclose(got[..., :2], want[..., :2], rtol=0,
                                   atol=1e-3,
                                   err_msg=f"{corruption}_{severity0}")
        if corruption != "clean":
            assert np.abs(want[..., :2] - jax_preds[0][..., :2]).max() > 1.0
    with open(os.path.join(out["output_dir"], "robust_C.val")) as f:
        assert [ln.split(":")[0] for ln in f.read().splitlines()] == \
            [f"{c}_{s}" for c, s in passes]

    want_dir = tmp_path / "jax_csv"
    want_dir.mkdir()
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.syspath_prepend(os.path.join(ROOT, "tools"))
    from test_corruption import write_final_csv as jax_write_final_csv

    jax_write_final_csv(jax_pcks, ["contrast"], str(want_dir), "robust",
                        "synthetic")
    with open(out["csv"], "rb") as f, \
            open(want_dir / "robust.csv", "rb") as g:
        assert f.read() == g.read()
