"""The other top-down families against the JAX package's: SimpleBaseline
ResNet-50/101/152 (Bottleneck blocks, expansion 4) and HRNet-W48, with
weights carried across by `advmix_tpu_torch.models.convert`, in the
unscanned layout and in the scanned one (`layer<k>_scan/block/...`: the
JAX package scans a ResNet stage's blocks after the first, whose tails
count from 1).

Forward parity in f32 at the tolerance of test_torch_models.py (rtol 1e-4,
atol 1e-5 of the output's largest magnitude): PoseResNet-50 at full trunk
width with a narrow deconv head at 64x64. The full-width YAML models are
checked key by key and shape by shape from `jax.eval_shape` (nothing is
compiled), with equal parameter counts.
"""

import os

import numpy as np
import pytest

from advmix_tpu.config import load_config as jax_load_config
from advmix_tpu.models import get_pose_net as jax_get_pose_net
from advmix_tpu.models.pose_resnet import PoseResNet as JaxPoseResNet
from advmix_tpu_torch.config import load_config
from advmix_tpu_torch.models import get_pose_net
from advmix_tpu_torch.models.convert import jax_to_torch_state_dict
from advmix_tpu_torch.models.pose_resnet import Bottleneck, PoseResNet

from test_torch_models import _jax_forward, _port_forward, assert_close
from torch_port_util import (calibrate_bn, random_variables, to_scanned,
                             variable_shapes)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = {
    "res50": "experiments/coco/resnet/res50_256x192_advmix.yaml",
    "res101": "experiments/coco/resnet/res101_256x192_advmix.yaml",
    "res152": "experiments/coco/resnet/res152_256x192_advmix.yaml",
    "w48": "experiments/coco/hrnet/w48_256x192_advmix.yaml",
    "mpii_w32": "experiments/mpii/hrnet/w32_256x256_advmix.yaml",
    "mpii_res50": "experiments/mpii/resnet/res50_256x256_advmix.yaml",
}
# the deepest ResNet, the widest HRNet and the two MPII models; ResNet-50's
# layouts are held in the forward test above
MAPPED = ["res152", "w48", "mpii_w32", "mpii_res50"]


@pytest.fixture(scope="module")
def res50():
    """Unscanned variables of PoseResNet-50 with a 16-channel deconv head,
    BN calibrated through the port's model, and an input."""
    jmodel = JaxPoseResNet(num_layers=50, num_joints=5,
                           num_deconv_filters=(16, 16, 16))
    port = PoseResNet(num_layers=50, num_joints=5,
                      num_deconv_filters=(16, 16, 16))
    calib = np.random.RandomState(40).randn(4, 64, 64, 3).astype(np.float32)
    flat = calibrate_bn(random_variables(variable_shapes(jmodel, (64, 64)),
                                         seed=41), port, calib)
    x = np.random.RandomState(42).randn(2, 64, 64, 3).astype(np.float32)
    return flat, x


@pytest.mark.parametrize("layout", ["unscanned", "scanned"])
def test_pose_resnet50_matches_jax(res50, layout):
    flat, x = res50
    scan = layout == "scanned"
    jmodel = JaxPoseResNet(num_layers=50, num_joints=5,
                           num_deconv_filters=(16, 16, 16), use_scan=scan)
    if scan:
        flat = to_scanned(flat, variable_shapes(jmodel, (64, 64)))
        # stages of 3, 4, 6, 3 blocks: every stage scans its tail
        assert {k.split("/")[1] for k in flat if "_scan" in k} == {
            f"layer{i}_scan" for i in (1, 2, 3, 4)}
    port = PoseResNet(num_layers=50, num_joints=5,
                      num_deconv_filters=(16, 16, 16))
    assert isinstance(port.layer3[5], Bottleneck)
    want = _jax_forward(jmodel, flat, x)
    got = _port_forward(port, flat, x)
    assert got.shape == (2, 5, 16, 16)
    assert np.abs(want).mean() > 0.1  # O(1) outputs, not a vacuous match
    assert_close(got, want)


def test_scanned_tail_blocks_count_from_one(res50):
    """The scanned stage's block axis b maps to block b + 1: a planted
    value in the scanned leaf's slot 0 lands in `layer2.1`, not in the
    first block."""
    flat, _ = res50
    jmodel = JaxPoseResNet(num_layers=50, num_joints=5,
                           num_deconv_filters=(16, 16, 16), use_scan=True)
    scanned = to_scanned(flat, variable_shapes(jmodel, (64, 64)))
    key = "params/layer2_scan/block/block_conv1/kernel"
    scanned[key] = scanned[key].copy()
    scanned[key][0] = 7.0
    port = PoseResNet(num_layers=50, num_joints=5,
                      num_deconv_filters=(16, 16, 16))
    sd = jax_to_torch_state_dict(scanned, port)
    assert float(sd["layer2.1.conv1.weight"].min()) == 7.0
    assert float(sd["layer2.0.conv1.weight"].abs().max()) < 7.0
    assert float(sd["layer2.2.conv1.weight"].abs().max()) < 7.0


def _expected_params(name):
    cfg = load_config(os.path.join(ROOT, YAMLS[name]))
    return cfg, get_pose_net(cfg)


@pytest.mark.parametrize("name", MAPPED)
@pytest.mark.parametrize("layout", ["unscanned", "scanned"])
def test_full_width_state_dict_maps_onto_jax(name, layout):
    """Every key and shape of the full-width model's state_dict maps onto
    the JAX variables of the same YAML in either layout (shapes from
    eval_shape), and the parameter counts agree."""
    path = os.path.join(ROOT, YAMLS[name])
    jcfg = jax_load_config(path)
    jcfg.defrost()
    jcfg.MODEL.EXTRA.USE_SCAN = layout == "scanned"
    jcfg.freeze()
    cfg, model = _expected_params(name)
    w, h = cfg.MODEL.IMAGE_SIZE
    shapes = variable_shapes(jax_get_pose_net(jcfg), (h, w))
    if layout == "scanned":
        assert any("_scan/" in k for k in shapes)
    flat = {k: np.zeros(s.shape, np.float32) for k, s in shapes.items()}
    model.load_state_dict(jax_to_torch_state_dict(flat, model), strict=True)
    n_jax = sum(int(np.prod(s.shape)) for k, s in shapes.items()
                if k.startswith("params/"))
    assert n_jax == sum(p.numel() for p in model.parameters())


# parameter counts of the published COCO 256x192 models, in millions to
# one decimal (SimpleBaseline's and HRNet's model tables)
PARAMS_M = {"res50": 34.0, "res101": 53.0, "res152": 68.6, "w48": 63.6}


@pytest.mark.parametrize("name", sorted(PARAMS_M))
def test_full_width_parameter_counts(name):
    _, model = _expected_params(name)
    n = sum(p.numel() for p in model.parameters())
    assert round(n / 1e6, 1) == PARAMS_M[name], n
