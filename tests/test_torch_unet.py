"""The UNet generator and the train-mode forward of the pose networks
against the JAX package's, weights carried across by
`advmix_tpu_torch.models.convert`.

Tolerance of the UNet and of the train-mode forwards in float64: 1e-5 of the
output's largest magnitude (and as much for the BatchNorm statistics, which
are O(1)). Both sides compute the same layers, but XLA and torch's CPU
kernels sum in different orders, and the JAX BatchNorm takes var = E[x^2] -
E[x]^2 where torch takes a two-pass variance: in f32 that rounding, divided
by each layer's deviation again, reaches 1.4e-5 of the range for
PoseResNet-18 at 64x64 and 3.4e-5 at 128x128 (measured here), so the f32
train-mode forwards are held to 1e-4 and the float64 ones, which show that
the semantics agree (momentum, the unbiased running variance, the batch
statistics in the normalization), to 1e-5.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advmix_tpu.models.pose_resnet import PoseResNet as JaxPoseResNet
from advmix_tpu.models.unet import UnetGenerator as JaxUnet
from advmix_tpu_torch.config import load_config
from advmix_tpu_torch.models import get_generator, get_pose_net, \
    load_generator_file
from advmix_tpu_torch.models.convert import jax_to_torch_state_dict, \
    jax_unet_to_torch_state_dict, torch_to_jax_leaves, unet_torch_key
from advmix_tpu_torch.models.layers import InstanceNorm2d, conv_transpose
from advmix_tpu_torch.models.pose_resnet import PoseResNet
from advmix_tpu_torch.models.unet import UnetGenerator

from torch_port_util import (random_variables, tiny_cfg, unflatten,
                             variable_shapes)

# two threads: the suite runs several workers side by side
torch.set_num_threads(2)

TOL = 1e-5


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _unet_variables(jmodel, hw, seed):
    x = jnp.zeros((1, hw, hw, 9), jnp.float32)
    tree = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), x))
    shapes = {"/".join(k): v for k, v in flax.traverse_util.flatten_dict(
        flax.core.unfreeze(tree)).items()}
    return random_variables(shapes, seed)


@pytest.mark.parametrize("with_tanh", [False, True])
def test_unet_forward_matches_jax(with_tanh):
    """num_downs 6, ngf 8, 64x64: every level of the recursion, the skip
    concat order, the transposed convs' kernel layout."""
    jmodel = JaxUnet(input_nc=9, num_downs=6, ngf=8, with_tanh=with_tanh)
    flat = _unet_variables(jmodel, 64, seed=0)
    x = np.random.RandomState(1).randn(2, 64, 64, 9).astype(np.float32)
    want = np.asarray(jmodel.apply(unflatten(flat), x)).transpose(0, 3, 1, 2)
    port = UnetGenerator(input_nc=9, num_downs=6, ngf=8, with_tanh=with_tanh)
    port.load_state_dict(jax_unet_to_torch_state_dict(flat, port),
                         strict=True)
    with torch.no_grad():
        got = port(_nchw(x))
    assert got.shape == (2, 3, 64, 64) and got.dtype == torch.float32
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TOL * np.abs(want).max())
    # and back again, leaf for leaf
    back = torch_to_jax_leaves(port)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v)


def test_unet_bf16_output_is_f32():
    from advmix_tpu_torch.models.layers import set_compute_dtype

    port = set_compute_dtype(UnetGenerator(num_downs=5, ngf=8),
                             torch.bfloat16, trainable=True)
    out = port(torch.randn(1, 9, 32, 32))
    assert out.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in port.parameters())


def test_unet_keys_are_the_reference_generators(tmp_path):
    """The nested module names are those of the reference `UnetGenerator`
    (`advmix_tpu/models/torch_convert.py:torch_unet_key`), so its `.pth`
    loads strictly, with or without a DataParallel prefix."""
    from advmix_tpu.models.torch_convert import torch_unet_key

    g = get_generator()
    keys = set(g.state_dict())
    want = set()
    for d in range(6):
        for kind in ("down", "up"):
            assert unet_torch_key(d, kind) == torch_unet_key(d, kind)
            want |= {torch_unet_key(d, kind) + ".weight",
                     torch_unet_key(d, kind) + ".bias"}
    assert keys == want
    assert g.state_dict()["model.model.0.weight"].shape == (64, 9, 4, 4)
    assert g.state_dict()["model.model.3.weight"].shape == (128, 3, 4, 4)
    path = str(tmp_path / "g.pth")
    torch.save({"state_dict": {"module." + k: v + 1.0
                               for k, v in g.state_dict().items()}}, path)
    g2 = get_generator()
    load_generator_file(g2, path)
    for k, v in g.state_dict().items():
        assert torch.equal(g2.state_dict()[k], v + 1.0)


def test_conv_transpose_sizing_and_instance_norm():
    """out = (in - 1) * s - 2p + k + output_padding, and InstanceNorm in
    f32 on a bf16 input."""
    x = torch.randn(1, 4, 5, 7)
    for k, p, op in ((4, 1, 0), (3, 1, 1), (2, 0, 0)):
        out = conv_transpose(4, 2, k, 2, p, op)(x)
        assert out.shape[2:] == (4 * 2 - 2 * p + k + op,
                                 6 * 2 - 2 * p + k + op)
    xb = (torch.randn(2, 3, 8, 8) * 3 + 1).to(torch.bfloat16)
    got = InstanceNorm2d(3)(xb)
    assert got.dtype == torch.bfloat16
    xf = xb.float()
    want = (xf - xf.mean((2, 3), keepdim=True)) / torch.sqrt(
        xf.var((2, 3), unbiased=False, keepdim=True) + 1e-5)
    assert torch.equal(got, want.to(torch.bfloat16))


def _train_forward_both(jmodel, port, flat, x, tol):
    v = unflatten(flat)
    want, mut = jmodel.apply(v, x, train=True, mutable=["batch_stats"])
    want = np.asarray(want).transpose(0, 3, 1, 2)
    port.load_state_dict(jax_to_torch_state_dict(flat, port), strict=True)
    port.train().to(torch.float64 if x.dtype == np.float64 else torch.float32)
    with torch.no_grad():
        got = port(_nchw(x)).numpy()
    assert got.dtype == x.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())
    stats = {"batch_stats/" + "/".join(k[-2:]): np.asarray(val) for k, val in
             flax.traverse_util.flatten_dict(
                 flax.core.unfreeze(mut["batch_stats"])).items()}
    after = {k: val for k, val in torch_to_jax_leaves(port).items()
             if k.startswith("batch_stats/")}
    assert set(after) == set(stats)
    moved = 0.0
    for k, val in stats.items():
        np.testing.assert_allclose(after[k], val, rtol=0,
                                   atol=tol * max(1.0, np.abs(val).max()))
    for k, val in flat.items():
        if k.startswith("batch_stats/"):
            moved = max(moved, float(np.abs(
                stats["batch_stats/" + "/".join(k.split("/")[-2:])]
                - val).max()))
    assert moved > 1e-2  # the running statistics did update


PRECISIONS = [(np.float32, 1e-4), (np.float64, TOL)]


@pytest.mark.parametrize("dtype,tol", PRECISIONS)
def test_pose_resnet18_train_forward_and_bn_buffers(dtype, tol):
    with jax.enable_x64(dtype == np.float64):
        jmodel = JaxPoseResNet(num_layers=18, num_joints=5,
                               num_deconv_filters=(16, 16, 16), dtype=dtype)
        port = PoseResNet(num_layers=18, num_joints=5,
                          num_deconv_filters=(16, 16, 16))
        flat = random_variables(variable_shapes(jmodel, (64, 64)), seed=2)
        flat = {k: v.astype(dtype) for k, v in flat.items()}
        x = np.random.RandomState(3).randn(4, 64, 64, 3).astype(dtype)
        _train_forward_both(jmodel, port, flat, x, tol)


@pytest.mark.parametrize("dtype,tol", PRECISIONS)
def test_tiny_hrnet_train_forward_and_bn_buffers(dtype, tol):
    from advmix_tpu.models.pose_hrnet import PoseHighResolutionNet

    cfg = tiny_cfg(load_config)
    extra = cfg.MODEL.EXTRA
    with jax.enable_x64(dtype == np.float64):
        jmodel = PoseHighResolutionNet(
            stage2_cfg=dict(extra["STAGE2"]), stage3_cfg=dict(extra["STAGE3"]),
            stage4_cfg=dict(extra["STAGE4"]), num_joints=17,
            final_conv_kernel=1, dtype=dtype)
        flat = random_variables(variable_shapes(jmodel, (64, 64)), seed=4)
        flat = {k: v.astype(dtype) for k, v in flat.items()}
        x = np.random.RandomState(5).randn(4, 64, 64, 3).astype(dtype)
        _train_forward_both(jmodel, get_pose_net(cfg), flat, x, tol)
