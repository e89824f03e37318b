"""Eval options of the port against the JAX package: the soft-argmax decode
(TEST.SOFT_ARGMAX), the eval and train steps' debug outputs, and the
debug-image dumps of `utils/vis.py`.

Tolerances: soft-argmax coordinates within 1e-4 heatmap px of the JAX
package's (the same f32 softmax and sums, ordered differently by XLA and
torch), confidences within rtol 1e-6 (both read the same heatmap value at
the same rounded coordinate); the tiny eval step under TEST.SOFT_ARGMAX
within 1e-3 heatmap px (softmax(160 * heatmap) scales the heatmaps' f32
rounding up) and maxvals within rtol 1e-4, as tests/test_torch_eval_step.py
holds the argmax path; debug heatmaps at f32 forward tolerance
(test_torch_models.py) and their argmax peaks equal; the dumped JPEG files
equal byte for byte.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advmix_tpu.config import load_config as jax_load_config
from advmix_tpu.engine import steps as jax_steps
from advmix_tpu.ops import heatmap as JH
from advmix_tpu.ops.heatmap import generate_target as jax_generate_target
from advmix_tpu.parallel import get_mesh
from advmix_tpu.utils import vis as jax_vis
from advmix_tpu_torch.config import load_config
from advmix_tpu_torch.data import COCODataset
from advmix_tpu_torch.engine import steps
from advmix_tpu_torch.engine.steps import make_eval_step
from advmix_tpu_torch.models import get_pose_net
from advmix_tpu_torch.models.convert import jax_to_torch_state_dict
from advmix_tpu_torch.ops import heatmap as H
from advmix_tpu_torch.utils import vis

from torch_port_util import (TINY_HEATMAP, TINY_IMAGE, calibrate_bn,
                             jax_hrnet, random_variables, tiny_cfg,
                             unflatten, variable_shapes)


def _heatmaps(seed, b, j, h, w):
    """Random maps with a Gaussian peak each, as a trained net's look: the
    soft-argmax then lands between pixels, near but not on the argmax."""
    rng = np.random.RandomState(seed)
    hm = rng.rand(b, j, h, w).astype(np.float32) * 0.05
    yy, xx = np.mgrid[0:h, 0:w]
    for bi in range(b):
        for ji in range(j):
            cx, cy = rng.uniform(-2, w + 1), rng.uniform(-2, h + 1)
            s = rng.uniform(1.0, 3.0)
            hm[bi, ji] += rng.uniform(0.2, 1.0) * np.exp(
                -((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s))
    hm[0, 0] = 0.0  # a flat map: the expectation is the grid's centre
    return hm


def _nhwc(hm):
    return jnp.asarray(hm.transpose(0, 2, 3, 1))


@pytest.mark.parametrize("shape", [(3, 16, 64, 64), (2, 17, 64, 48)])
def test_soft_argmax_matches_jax(shape):
    hm = _heatmaps(sum(shape), *shape)
    preds, maxvals = H.soft_argmax(torch.from_numpy(hm))
    jpreds, jmax = JH.soft_argmax(_nhwc(hm))
    assert preds.shape == (shape[0], shape[1], 2)
    assert maxvals.shape == (shape[0], shape[1], 1)
    np.testing.assert_allclose(preds.numpy(), np.asarray(jpreds), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(maxvals.numpy(), np.asarray(jmax), rtol=1e-6)
    # the flat map's expectation is the centre of the grid
    h, w = shape[2:]
    np.testing.assert_allclose(preds[0, 0].numpy(), [(w - 1) / 2,
                                                     (h - 1) / 2], atol=1e-4)


@pytest.mark.parametrize("post_process", [True, False])
def test_final_preds_softargmax_match_jax(post_process):
    b, j, h, w = 4, 16, 64, 64
    hm = _heatmaps(7, b, j, h, w)
    rng = np.random.RandomState(8)
    center = rng.uniform(100, 400, (b, 2)).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, (b, 2)).astype(np.float32)
    preds, maxvals = H.get_final_preds_softargmax(
        torch.from_numpy(hm), torch.from_numpy(center),
        torch.from_numpy(scale), post_process=post_process)
    jpreds, jmax = JH.get_final_preds_softargmax(
        _nhwc(hm), jnp.asarray(center), jnp.asarray(scale),
        post_process=post_process)
    # 1e-4 heatmap px, times the inverse affine's scale of up to
    # 2 * 200 / 64 image px per heatmap px
    np.testing.assert_allclose(preds.numpy(), np.asarray(jpreds), rtol=0,
                               atol=1e-4 * 2 * 200 / 64 + 1e-4)
    np.testing.assert_allclose(maxvals.numpy(), np.asarray(jmax), rtol=1e-6)


@pytest.fixture(scope="module")
def tiny():
    """The tiny HRNet in both packages with the same weights, and an eval
    batch with a padded tail row."""
    cfg = tiny_cfg(load_config)
    w, h = TINY_IMAGE
    jmodel = jax_hrnet(cfg.MODEL.EXTRA)
    port = get_pose_net(cfg)
    calib = np.random.RandomState(60).randn(4, h, w, 3).astype(np.float32)
    flat = calibrate_bn(random_variables(variable_shapes(jmodel, (h, w)),
                                         seed=61), port, calib)
    port.load_state_dict(jax_to_torch_state_dict(flat, port))
    port.eval()
    rng = np.random.RandomState(62)
    b = 4
    image = rng.randn(b, h, w, 3).astype(np.float32)
    joints = rng.uniform(0, [w, h], (b, 17, 2)).astype(np.float32)
    vis_ = (rng.rand(b, 17) > 0.2).astype(np.float32)
    target, _, tw = jax_generate_target(jnp.asarray(joints),
                                        jnp.asarray(vis_), TINY_IMAGE,
                                        TINY_HEATMAP, 2)
    batch = dict(image=image, target=np.asarray(target), target_weight=tw,
                 center=rng.uniform(100, 400, (b, 2)).astype(np.float32),
                 scale=rng.uniform(0.5, 2.0, (b, 2)).astype(np.float32),
                 valid=np.array([1, 1, 1, 0], np.float32))
    return jmodel, flat, port, batch


def _jax_step(jmodel, flat, batch, debug, **test):
    jcfg = tiny_cfg(jax_load_config, FLIP_TEST=True, SHIFT_HEATMAP=True,
                    **test)
    jstep = jax_steps.make_eval_step(jmodel, jcfg, COCODataset.flip_pairs,
                                     get_mesh(1), debug=debug)
    v = unflatten(flat)
    return jstep(v["params"], v["batch_stats"],
                 {k: jnp.asarray(x) for k, x in batch.items()})


def _port_batch(batch):
    out = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    out["target"] = torch.from_numpy(np.ascontiguousarray(
        batch["target"].transpose(0, 3, 1, 2)))
    out["target_weight"] = torch.from_numpy(np.array(batch["target_weight"]))
    return out


@pytest.mark.parametrize("post_process", [True, False])
def test_eval_step_soft_argmax_matches_jax(tiny, monkeypatch, post_process):
    """TEST.SOFT_ARGMAX: the step decodes by soft-argmax and never calls the
    decode kernel's wrapper."""
    jmodel, flat, port, batch = tiny
    test = dict(SOFT_ARGMAX=True, POST_PROCESS=post_process)
    jpreds, jmax, jmet = _jax_step(jmodel, flat, batch, False, **test)

    def no_decode(*a, **k):
        raise AssertionError("the decode kernel ran under TEST.SOFT_ARGMAX")

    monkeypatch.setattr(steps, "decode_heatmaps", no_decode)
    cfg = tiny_cfg(load_config, FLIP_TEST=True, SHIFT_HEATMAP=True, **test)
    preds, maxvals, met = make_eval_step(port, cfg, COCODataset.flip_pairs)(
        _port_batch(batch))
    # softmax(160 * heatmap) turns the heatmaps' f32 rounding into a shift
    # of the expectation: hold it to 1e-3 heatmap px, which the inverse
    # affine scales by up to 200 * scale / (heatmap side) image px
    px = 200.0 * batch["scale"].max() / min(TINY_HEATMAP)
    np.testing.assert_allclose(preds.numpy(), np.asarray(jpreds), rtol=0,
                               atol=1e-3 * px)
    jm = np.asarray(jmax)
    np.testing.assert_allclose(maxvals.numpy(), jm, rtol=1e-4,
                               atol=1e-5 * np.abs(jm).max())
    for k in ("pck_hit_j", "pck_valid_j", "acc"):
        np.testing.assert_array_equal(np.asarray(met[k]),
                                      np.asarray(jmet[k]), err_msg=k)
    # not the argmax decode's answer
    cfg_arg = tiny_cfg(load_config, FLIP_TEST=True, SHIFT_HEATMAP=True,
                       POST_PROCESS=post_process)
    monkeypatch.undo()
    argmax_preds = make_eval_step(port, cfg_arg, COCODataset.flip_pairs)(
        _port_batch(batch))[0]
    assert np.abs(argmax_preds.numpy() - preds.numpy()).max() > 1e-2


def test_eval_step_debug_outputs_match_jax(tiny):
    jmodel, flat, port, batch = tiny
    *_, jdbg = _jax_step(jmodel, flat, batch, True, POST_PROCESS=True)
    cfg = tiny_cfg(load_config, FLIP_TEST=True, SHIFT_HEATMAP=True,
                   POST_PROCESS=True)
    step = make_eval_step(port, cfg, COCODataset.flip_pairs, debug=True)
    out = step(_port_batch(batch))
    assert len(out) == 4
    dbg = out[3]
    want = np.asarray(jdbg["output"]).transpose(0, 3, 1, 2)
    got = dbg["output"].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_array_equal(dbg["pred_coords"].numpy(),
                                  np.asarray(jdbg["pred_coords"]))
    np.testing.assert_allclose(dbg["pred_maxvals"].numpy(),
                               np.asarray(jdbg["pred_maxvals"]), rtol=1e-4)
    # debug=False is the three-item step, and both give the same preds
    plain = make_eval_step(port, cfg, COCODataset.flip_pairs)(
        _port_batch(batch))
    assert len(plain) == 3 and torch.equal(plain[0], out[0])


def _debug_cfg(load, **flags):
    cfg = load()
    cfg.defrost()
    cfg.DEBUG.DEBUG = True
    for k in ("SAVE_BATCH_IMAGES_GT", "SAVE_BATCH_IMAGES_PRED",
              "SAVE_HEATMAPS_GT", "SAVE_HEATMAPS_PRED"):
        cfg.DEBUG[k] = flags.get(k, True)
    cfg.freeze()
    return cfg


@pytest.mark.parametrize("b", [3, 10])
def test_save_debug_images_bytes_equal_jax(tmp_path, b):
    """The same inputs, four files each, byte for byte; 10 images wrap the
    overlay grid onto a second row."""
    rng = np.random.RandomState(b)
    h, w, hh, hw, j = 64, 48, 16, 12, 16
    images = (rng.randn(b, h, w, 3) * 1.2).astype(np.float32)
    joints = rng.uniform(-5, [w + 5, h + 5], (b, j, 2)).astype(np.float32)
    joints_vis = (rng.rand(b, j) > 0.3).astype(np.float32)
    target = rng.rand(b, hh, hw, j).astype(np.float32)
    output = (rng.randn(b, hh, hw, j) * 0.6).astype(np.float32)
    pred = rng.uniform(0, [hw, hh], (b, j, 2)).astype(np.float32) * 4
    for name, mod, load in (("port", vis, load_config),
                            ("jax", jax_vis, jax_load_config)):
        mod.save_debug_images(_debug_cfg(load), images, joints, joints_vis,
                              target, pred, output,
                              str(tmp_path / name / "dbg"))
    got = sorted(os.listdir(tmp_path / "port"))
    assert got == sorted(os.listdir(tmp_path / "jax")) == [
        "dbg_gt.jpg", "dbg_hm_gt.jpg", "dbg_hm_pred.jpg", "dbg_pred.jpg"]
    for f in got:
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes(), f
    np.testing.assert_array_equal(vis.denormalize(images),
                                  jax_vis.denormalize(images))


def test_save_debug_images_flags_gate_each_file(tmp_path):
    rng = np.random.RandomState(0)
    args = (rng.randn(2, 32, 32, 3).astype(np.float32),
            np.zeros((2, 4, 2), np.float32), np.ones((2, 4), np.float32),
            np.zeros((2, 8, 8, 4), np.float32), np.zeros((2, 4, 2)),
            np.zeros((2, 8, 8, 4), np.float32))
    cfg = _debug_cfg(load_config, SAVE_BATCH_IMAGES_GT=False,
                     SAVE_HEATMAPS_PRED=False)
    vis.save_debug_images(cfg, *args, str(tmp_path / "a" / "x"))
    assert sorted(os.listdir(tmp_path / "a")) == ["x_hm_gt.jpg",
                                                  "x_pred.jpg"]
    off = load_config()  # DEBUG.DEBUG false: nothing at all
    vis.save_debug_images(off, *args, str(tmp_path / "b" / "x"))
    assert not (tmp_path / "b").exists()


NO_CV2 = r"""
import sys


class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "cv2":
            raise ImportError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, Block())
import numpy as np

from advmix_tpu_torch.config import load_config
from advmix_tpu_torch.utils import vis

cfg = load_config()
cfg.defrost()
cfg.DEBUG.DEBUG = cfg.DEBUG.SAVE_BATCH_IMAGES_GT = True
cfg.freeze()
try:
    vis.save_debug_images(cfg, np.zeros((1, 8, 8, 3), np.float32),
                          np.zeros((1, 2, 2)), np.ones((1, 2)),
                          np.zeros((1, 2, 2, 2)), np.zeros((1, 2, 2)),
                          np.zeros((1, 2, 2, 2)), sys.argv[1])
except ImportError as e:
    print("raised:", e)
"""


def test_dumps_without_cv2_raise(tmp_path):
    """The dumps need cv2: where it cannot be imported they raise, and
    write nothing, rather than skip quietly."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", NO_CV2, str(tmp_path / "d" / "x")], cwd=root,
        env=dict(os.environ, PYTHONPATH=root), capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "raised: blocked import of cv2" in proc.stdout
    assert not list((tmp_path / "d").glob("*.jpg"))
