"""The port's models against the JAX package's, with weights carried across
by `advmix_tpu_torch.models.convert.jax_to_torch_state_dict`.

Tolerance for forward parity, in f32: rtol 1e-4 and atol 1e-5 of the
output's largest magnitude (the random nets' heatmaps reach ~10, not 1).
Both sides compute the same convolutions and BatchNorms, but XLA and
torch's CPU kernels sum in different orders, and the rounding compounds
through the layers: the tiny HRNet's own f32 and f64 forwards differ by
about 1e-6 of the output's range.
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from advmix_tpu.config import load_config as jax_load_config
from advmix_tpu.models.pose_resnet import PoseResNet as JaxPoseResNet
from advmix_tpu_torch.config import load_config
from advmix_tpu_torch.models import get_pose_net
from advmix_tpu_torch.models.convert import jax_to_torch_state_dict
from advmix_tpu_torch.models.pose_resnet import PoseResNet

from torch_port_util import (TINY_IMAGE, calibrate_bn, jax_hrnet,
                             random_variables,
                             tiny_cfg, to_scanned, unflatten,
                             variable_shapes)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W32 = os.path.join(ROOT, "experiments/coco/hrnet/w32_256x192_advmix.yaml")
ATOL, RTOL = 1e-5, 1e-4


def _jax_forward(model, flat, x_nhwc):
    v = unflatten(flat)
    out = jax.jit(lambda v, x: model.apply(v, x, train=False))(v, x_nhwc)
    return np.asarray(out).transpose(0, 3, 1, 2)


def assert_close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL * np.abs(want).max())


def _port_forward(model, flat, x_nhwc):
    model.load_state_dict(jax_to_torch_state_dict(flat, model), strict=True)
    with torch.no_grad():
        return model.eval()(torch.from_numpy(
            np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))).numpy()


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_cfg(load_config)
    h, w = TINY_IMAGE[1], TINY_IMAGE[0]
    flat = random_variables(variable_shapes(jax_hrnet(cfg.MODEL.EXTRA),
                                            (h, w)), seed=0)
    calib = np.random.RandomState(6).randn(4, h, w, 3).astype(np.float32)
    flat = calibrate_bn(flat, get_pose_net(cfg), calib)
    x = np.random.RandomState(1).randn(2, h, w, 3).astype(np.float32)
    return cfg, flat, x


@pytest.mark.parametrize("layout", ["unscanned", "scanned"])
def test_tiny_hrnet_matches_jax(tiny, layout):
    cfg, flat, x = tiny
    scan = layout == "scanned"
    jmodel = jax_hrnet(cfg.MODEL.EXTRA, use_scan=scan)
    if scan:
        flat = to_scanned(flat, variable_shapes(jmodel, x.shape[1:3]))
        assert any("_scan/" in k for k in flat)
    want = _jax_forward(jmodel, flat, x)
    got = _port_forward(get_pose_net(cfg), flat, x)
    assert np.abs(want).mean() > 0.1  # O(1) outputs, not a vacuous match
    assert_close(got, want)


def test_pose_resnet_matches_jax():
    """PoseResNet-18 with a narrow deconv head: covers the transposed-conv
    kernel layout and the ResNet naming."""
    jmodel = JaxPoseResNet(num_layers=18, num_joints=5,
                           num_deconv_filters=(16, 16, 16))
    port = PoseResNet(num_layers=18, num_joints=5,
                      num_deconv_filters=(16, 16, 16))
    calib = np.random.RandomState(7).randn(4, 32, 32, 3).astype(np.float32)
    flat = calibrate_bn(random_variables(variable_shapes(jmodel, (32, 32)),
                                         seed=2), port, calib)
    x = np.random.RandomState(3).randn(2, 32, 32, 3).astype(np.float32)
    want = _jax_forward(jmodel, flat, x)
    got = _port_forward(port, flat, x)
    assert_close(got, want)


@pytest.mark.parametrize("layout", ["unscanned", "scanned"])
def test_w32_state_dict_maps_onto_jax(layout):
    """Every key and shape of the full-width W32 state_dict maps onto the
    JAX variables (shapes from eval_shape: nothing is compiled), and the
    parameter counts agree."""
    jcfg = jax_load_config(W32)
    model = get_pose_net(load_config(W32))
    jmodel = jax_hrnet(jcfg.MODEL.EXTRA, use_scan=layout == "scanned")
    shapes = variable_shapes(jmodel, (256, 192))
    flat = {k: np.zeros(s.shape, np.float32) for k, s in shapes.items()}
    model.load_state_dict(jax_to_torch_state_dict(flat, model), strict=True)
    n_jax = sum(int(np.prod(s.shape)) for k, s in shapes.items()
                if k.startswith("params/"))
    assert n_jax == sum(p.numel() for p in model.parameters()) == 28536113


def test_w32_forward_matches_jax():
    """Full-width HRNet-W32 at 256x192, batch 1, weights in the YAML's
    scanned layout."""
    jcfg = jax_load_config(W32)
    jmodel = jax_hrnet(jcfg.MODEL.EXTRA, use_scan=True)
    port = get_pose_net(load_config(W32))
    un_shapes = variable_shapes(jax_hrnet(jcfg.MODEL.EXTRA), (256, 192))
    calib = np.random.RandomState(8).randn(2, 256, 192, 3).astype(np.float32)
    flat = calibrate_bn(random_variables(un_shapes, seed=4), port, calib)
    flat = to_scanned(flat, variable_shapes(jmodel, (256, 192)))
    x = np.random.RandomState(5).randn(1, 256, 192, 3).astype(np.float32)
    want = _jax_forward(jmodel, flat, x)
    got = _port_forward(port, flat, x)
    assert got.shape == (1, 17, 64, 48)
    assert_close(got, want)


def test_convert_rejects_missing_and_extra_variables(tiny):
    cfg, flat, _ = tiny
    model = get_pose_net(cfg)
    missing = {k: v for k, v in flat.items() if "final_layer" not in k}
    with pytest.raises(KeyError):
        jax_to_torch_state_dict(missing, model)
    extra = dict(flat)
    extra["params/bogus_conv/kernel"] = np.zeros((1, 1, 1, 1), np.float32)
    with pytest.raises(KeyError):
        jax_to_torch_state_dict(extra, model)
