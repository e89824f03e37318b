"""The port's COCO evaluation against the JAX package's and against the
loop-faithful pycocotools oracle. Both packages run the same float64
numpy and C++ code here, so results must be equal, not close."""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from advmix_tpu.config import load_config as jax_load_config
from advmix_tpu.evaluation.coco_eval import \
    evaluate_coco_keypoints as jax_evaluate
from advmix_tpu_torch.config import load_config
from advmix_tpu_torch.evaluation.coco_eval import evaluate_coco_keypoints
from advmix_tpu_torch.evaluation.cocoeval_np import COCOKeypointEval

from cocoeval_oracle import OracleCOCOeval
from test_cocoeval_oracle import make_fixture


def _fixture(tmp_path, seed=0, n_img=6):
    """A GT json and noisy, partly duplicated candidates for it."""
    rng = np.random.RandomState(seed)
    images, anns, preds, boxes, paths = [], [], [], [], []
    aid = 1
    for i in range(1, n_img + 1):
        images.append(dict(id=i, width=640, height=480))
        for _ in range(rng.randint(1, 4)):
            cx, cy = rng.uniform(100, 500), rng.uniform(100, 350)
            kps = np.zeros((17, 3))
            kps[:, 0] = cx + rng.randn(17) * 25
            kps[:, 1] = cy + rng.randn(17) * 25
            kps[:, 2] = 2
            x0, y0 = kps[:, 0].min() - 5, kps[:, 1].min() - 5
            w, h = kps[:, 0].max() - x0 + 10, kps[:, 1].max() - y0 + 10
            anns.append(dict(id=aid, image_id=i, category_id=1,
                             keypoints=kps.reshape(-1).tolist(),
                             num_keypoints=17, bbox=[x0, y0, w, h],
                             area=float(w * h), iscrowd=0))
            aid += 1
            for _ in range(rng.randint(1, 4)):  # near-duplicate candidates
                p = np.zeros((17, 3), np.float32)
                p[:, :2] = kps[:, :2] + rng.randn(17, 2) * rng.uniform(1, 8)
                p[:, 2] = rng.rand(17)
                preds.append(p)
                boxes.append([cx, cy, w / 200, h / 200, w * h,
                              rng.uniform(0.5, 1)])
                paths.append(f"/data/val2017/{i:012d}.jpg")
    ann_file = str(tmp_path / "person_keypoints_val2017.json")
    with open(ann_file, "w") as f:
        json.dump(dict(images=images, annotations=anns), f)
    ds = SimpleNamespace(image_set="val2017", num_joints=17,
                         ann_file=ann_file)
    return ds, np.stack(preds), np.asarray(boxes), paths


def _cfg(load, soft):
    cfg = load()
    cfg.defrost()
    cfg.TEST.IN_VIS_THRE = 0.2
    cfg.TEST.OKS_THRE = 0.9
    cfg.TEST.SOFT_NMS = soft
    cfg.freeze()
    return cfg


@pytest.mark.parametrize("soft", [False, True])
def test_evaluate_matches_jax(tmp_path, soft):
    ds, preds, boxes, paths = _fixture(tmp_path)
    out_p, out_j = tmp_path / "port", tmp_path / "jax"
    nv, ap = evaluate_coco_keypoints(_cfg(load_config, soft), ds, preds,
                                     str(out_p), boxes, paths,
                                     device=torch.device("cpu"))
    jnv, jap = jax_evaluate(_cfg(jax_load_config, soft), ds, preds,
                            str(out_j), boxes, paths)
    assert ap == jap and dict(nv) == dict(jnv)
    res = os.path.join("results", "keypoints_val2017_results_0.json")
    with open(out_p / res) as f, open(out_j / res) as g:
        got, want = json.load(f), json.load(g)
    assert got == want
    if not soft:
        assert len(got) < len(preds)  # NMS removed the duplicates
    assert 0.0 < ap <= 1.0


@pytest.mark.parametrize("seed", range(40))
def test_cocoeval_matches_oracle(seed):
    gt, dt = make_fixture(seed)
    np.testing.assert_array_equal(COCOKeypointEval(gt, dt).run(),
                                  OracleCOCOeval(gt, dt).run())
