"""The port's eval step against the JAX package's `make_eval_step`, on the
tiny HRNet with flip test, the heatmap shift and post-processing on, and a
padded tail (`valid` zeros).

Tolerances: the heatmaps agree to f32 rounding (see test_torch_models), so
the argmax picks, the PCK counts and the quarter offsets are equal; preds
then differ only by the f32 inverse affine, 1e-3 px at these coordinates;
maxvals and the loss by rtol 1e-4.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from advmix_tpu.config import load_config as jax_load_config
from advmix_tpu.engine import steps as jax_steps
from advmix_tpu.ops.heatmap import generate_target as jax_generate_target
from advmix_tpu.parallel import get_mesh
from advmix_tpu_torch.config import load_config
from advmix_tpu_torch.data import COCODataset
from advmix_tpu_torch.engine.steps import make_eval_step
from advmix_tpu_torch.models import get_pose_net
from advmix_tpu_torch.models.convert import jax_to_torch_state_dict

from torch_port_util import (TINY_HEATMAP, TINY_IMAGE, calibrate_bn,
                             jax_hrnet, random_variables, tiny_cfg,
                             unflatten, variable_shapes)

TEST_FLAGS = dict(FLIP_TEST=True, SHIFT_HEATMAP=True, POST_PROCESS=True)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("loss", ["smooth_l1", "ohkm"])
def test_eval_step_matches_jax(loss):
    cfg = tiny_cfg(load_config, **TEST_FLAGS)
    jcfg = tiny_cfg(jax_load_config, **TEST_FLAGS)
    if loss == "ohkm":
        for c in (cfg, jcfg):
            c.defrost()
            c.LOSS.USE_OHKM = True
            c.freeze()
    w, h = TINY_IMAGE
    jmodel = jax_hrnet(cfg.MODEL.EXTRA)
    port = get_pose_net(cfg)
    calib = np.random.RandomState(10).randn(4, h, w, 3).astype(np.float32)
    flat = calibrate_bn(random_variables(variable_shapes(jmodel, (h, w)),
                                         seed=11), port, calib)
    port.load_state_dict(jax_to_torch_state_dict(flat, port))
    port.eval()

    rng = np.random.RandomState(12)
    b = 4
    image = rng.randn(b, h, w, 3).astype(np.float32)
    joints = rng.uniform(0, [w, h], (b, 17, 2)).astype(np.float32)
    vis = (rng.rand(b, 17) > 0.2).astype(np.float32)
    target, _, tw = jax_generate_target(jnp.asarray(joints),
                                        jnp.asarray(vis), TINY_IMAGE,
                                        TINY_HEATMAP, 2)
    center = rng.uniform(100, 400, (b, 2)).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, (b, 2)).astype(np.float32)
    valid = np.array([1, 1, 1, 0], np.float32)  # a padded tail row

    pairs = COCODataset.flip_pairs
    jstep = jax_steps.make_eval_step(jmodel, jcfg, pairs, get_mesh(1))
    v = unflatten(flat)
    jpreds, jmax, jmet = jstep(v["params"], v["batch_stats"], {
        "image": jnp.asarray(image), "target": target, "target_weight": tw,
        "center": jnp.asarray(center), "scale": jnp.asarray(scale),
        "valid": jnp.asarray(valid)})

    step = make_eval_step(port, cfg, pairs)
    preds, maxvals, met = step({
        "image": torch.from_numpy(image),
        "target": torch.from_numpy(np.ascontiguousarray(
            np.asarray(target).transpose(0, 3, 1, 2))),
        "target_weight": torch.from_numpy(np.array(tw)),
        "center": torch.from_numpy(center), "scale": torch.from_numpy(scale),
        "valid": torch.from_numpy(valid)})

    assert preds.shape == (b, 17, 2) and maxvals.shape == (b, 17, 1)
    np.testing.assert_allclose(preds.numpy(), np.asarray(jpreds), atol=1e-3,
                               rtol=0)
    jm = np.asarray(jmax)
    np.testing.assert_allclose(maxvals.numpy(), jm, rtol=1e-4,
                               atol=1e-5 * np.abs(jm).max())
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-4)
    for k in ("pck_hit_j", "pck_valid_j", "acc", "acc_cnt"):
        np.testing.assert_array_equal(np.asarray(met[k]),
                                      np.asarray(jmet[k]), err_msg=k)
    # the padded row is out of the PCK counts
    assert float(met["pck_valid_j"].sum()) <= vis[:3].sum()


def test_eval_step_survives_jax_tools_on_sys_path():
    """The parity test in a fresh interpreter whose sys.path starts with the
    JAX package's `tools/`, as tests/test_misc_paths.py:187 leaves it in a
    worker of the Tier-1 run: there the decode op's first call imports
    `torch._dynamo` (and cProfile) for the first time, as it did when both
    cases failed with `module 'profile' has no attribute 'run'`."""
    code = ("import sys, pytest; "
            f"sys.path.insert(0, {os.path.join(REPO, 'tools')!r}); "
            "sys.exit(pytest.main(['-q', '-p', 'no:cacheprovider', "
            "'tests/test_torch_eval_step.py', '-k', "
            "'test_eval_step_matches_jax and smooth_l1']))")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-2000:]
    assert "1 passed" in r.stdout
