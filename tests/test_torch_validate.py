"""The port's entry point, `python -m advmix_tpu_torch.tools.validate
--device cpu`, against the JAX package's `validate` on a small JPEG COCO
tree, both with the same tiny-HRNet weights (an `.npz` of the JAX
variables, which TEST.MODEL_FILE hands the port).

Random weights give an AP near 0 on both sides, so the test also holds the
results json against the JAX one: equal image ids, scores within rtol 1e-4
(mean maxvals; f32 heatmaps, see test_torch_models) and keypoints within
1e-3 px (f32 inverse affine at image coordinates).
"""

import json
import os
import subprocess
import sys

import cv2
import numpy as np
import yaml

from advmix_tpu.config import load_config as jax_load_config
from advmix_tpu.data import Loader as JaxLoader
from advmix_tpu.data import build_dataset as jax_build_dataset
from advmix_tpu.engine import steps as jax_steps
from advmix_tpu.engine import trainer as jax_trainer
from advmix_tpu.parallel import get_mesh
from advmix_tpu.parallel.mesh import replicate
from advmix_tpu_torch.config import load_config
from advmix_tpu_torch.models import get_pose_net

from torch_port_util import (TINY_EXTRA, TINY_HEATMAP, TINY_IMAGE,
                             calibrate_bn, jax_hrnet, random_variables,
                             unflatten, variable_shapes)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _coco_tree(root):
    """4 JPEG images of 2 people each, as tests/test_integration_data.py
    builds its tree."""
    os.makedirs(os.path.join(root, "annotations"))
    os.makedirs(os.path.join(root, "val2017"))
    rng = np.random.RandomState(0)
    images, anns = [], []
    for i in range(1, 5):
        img = np.full((480, 640, 3), 127, np.uint8)
        for _ in range(2):
            cx, cy = rng.uniform(150, 500), rng.uniform(150, 330)
            kps = []
            for _ in range(17):
                x, y = cx + rng.uniform(-40, 40), cy + rng.uniform(-60, 60)
                kps += [float(x), float(y), 2]
                cv2.circle(img, (int(x), int(y)), 3,
                           (int(rng.randint(255)),) * 3, -1)
            xs, ys = kps[0::3], kps[1::3]
            x0, y0 = min(xs) - 10, min(ys) - 10
            w, h = max(xs) - x0 + 20, max(ys) - y0 + 20
            anns.append(dict(id=len(anns) + 1, image_id=i, category_id=1,
                             keypoints=kps, num_keypoints=17,
                             bbox=[x0, y0, w, h], area=float(w * h),
                             iscrowd=0))
        cv2.imwrite(os.path.join(root, "val2017", "%012d.jpg" % i), img)
        images.append(dict(id=i, width=640, height=480,
                           file_name="%012d.jpg" % i))
    with open(os.path.join(root, "annotations",
                           "person_keypoints_val2017.json"), "w") as f:
        json.dump(dict(images=images, annotations=anns,
                       categories=[dict(id=1, name="person")]), f)


def test_validate_entry_point_matches_jax(tmp_path):
    coco = str(tmp_path / "coco")
    _coco_tree(coco)
    w, h = TINY_IMAGE
    jmodel = jax_hrnet(TINY_EXTRA)
    calib = np.random.RandomState(20).randn(4, h, w, 3).astype(np.float32)
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
                                         seed=21),
                        get_pose_net(load_config(cfg_path)), calib)
    np.savez(str(tmp_path / "w.npz"), **flat)

    # the JAX package's validate, in process, on a one-device mesh
    jcfg = jax_load_config(cfg_path)
    mesh = get_mesh(1)
    ds = jax_build_dataset(jcfg, is_train=False)
    v = unflatten(flat)
    jax_out = str(tmp_path / "jax_out")
    _, jax_ap = jax_trainer.validate(
        jcfg, jax_steps.make_eval_step(jmodel, jcfg, ds.flip_pairs, mesh),
        jax_trainer.make_eval_preprocessor(jcfg),
        replicate(v["params"], mesh), replicate(v["batch_stats"], mesh), ds,
        JaxLoader(ds, 4, shuffle=False), mesh, jax_out)

    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "advmix_tpu_torch.tools.validate", "--cfg",
         cfg_path, "--device", "cpu"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out_dir = os.path.join(str(tmp_path / "output") + "_robustness", "coco",
                           "pose_hrnet", "test_corruption")
    assert "loaded model" in proc.stderr
    with open(os.path.join(out_dir, "robust_C.val")) as f:
        line = f.read().strip()
    ap = float(line.split("AP = ")[1].split("\t")[0])
    assert ap == jax_ap

    res = os.path.join("results", "keypoints_val2017_results_0.json")
    with open(os.path.join(out_dir, res)) as f, \
            open(os.path.join(jax_out, res)) as g:
        got, want = json.load(f), json.load(g)
    assert [r["image_id"] for r in got] == [r["image_id"] for r in want]
    np.testing.assert_allclose([r["score"] for r in got],
                               [r["score"] for r in want], rtol=1e-4)
    np.testing.assert_allclose(
        np.array([r["keypoints"] for r in got]).reshape(-1, 17, 3)[..., :2],
        np.array([r["keypoints"] for r in want]).reshape(-1, 17, 3)[..., :2],
        atol=1e-3, rtol=0)
