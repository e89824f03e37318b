"""The port's HigherHRNet against the JAX package's, and its weight layouts.

A tiny HigherHRNet (the W32 topology at widths 4..32, 5 joints, tags per
joint, one deconv stage of 8 filters and 2 BasicBlocks, 64x64 input) with
seeded weights carried across by `models/convert.py`:

- eval mode in f32: both heads within rtol 1e-4 and atol 1e-5 of the
  head's largest magnitude (the tolerance of tests/test_torch_models.py);
- eval and train mode in float64: both heads within 1e-9 of the largest
  magnitude, and train mode's updated BN running statistics within 1e-9
  (in f32 the two packages' variance formulas differ, see ROADMAP.md);
- an official-layout HigherHRNet state dict (tests/test_higher_convert.py's
  THigher) loads with strict=True and reproduces the torch outputs to 1e-5;
- the JAX variables convert in both the unscanned and the scanned layout
  with no key missing or left over, and `torch_to_jax_leaves` gives every
  JAX leaf back bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import enable_x64

from advmix_tpu.models.higher_hrnet import HigherHRNet as JaxHigherHRNet
from advmix_tpu_torch.config import load_config
from advmix_tpu_torch.models import get_pose_net
from advmix_tpu_torch.models.convert import jax_to_torch_state_dict, \
    torch_to_jax_leaves
from advmix_tpu_torch.models.higher_hrnet import HigherHRNet

from test_higher_convert import J as OFFICIAL_J, THigher, _randomize
from test_hrnet_convert import STAGES as OFFICIAL_STAGES
from torch_port_util import (TINY_EXTRA, calibrate_bn, random_variables,
                             to_scanned, unflatten, variable_shapes)

torch.set_num_threads(2)

J, FILTERS, BLOCKS, SIZE = 5, 8, 2, 64
ATOL, RTOL = 1e-5, 1e-4


# one module of one block per branch and one BasicBlock: the JAX package's
# float64 steps compile in seconds instead of a minute
SHALLOW = dict(
    {k: (dict(v, NUM_MODULES=1, NUM_BLOCKS=[1] * v["NUM_BRANCHES"])
         if isinstance(v, dict) else v) for k, v in TINY_EXTRA.items()},
    NUM_BASIC_BLOCKS=1)


def higher_cfg(load=load_config, size=SIZE, joints=J, extra=None):
    """A frozen config of either package for the tiny HigherHRNet
    (`extra`: the MODEL.EXTRA stages, default TINY_EXTRA's)."""
    cfg = load()
    cfg.defrost()
    cfg.MODEL.NAME = "pose_higher_hrnet"
    cfg.MODEL.NUM_JOINTS = joints
    cfg.MODEL.TAG_PER_JOINT = True
    cfg.MODEL.IMAGE_SIZE = [size, size]
    cfg.MODEL.HEATMAP_SIZE = [size // 4, size // 4]
    cfg.MODEL.SIGMA = 2
    cfg.TEST.FLIP_TEST = True
    ext = {k: (dict(v) if isinstance(v, dict) else v)
           for k, v in TINY_EXTRA.items()}
    ext.update(NUM_BASIC_BLOCKS=BLOCKS,
               DECONV=dict(NUM_DECONVS=1, NUM_CHANNELS=[FILTERS],
                           CAT_OUTPUT=[True]))
    ext.update(extra or {})
    cfg.MODEL.EXTRA = ext
    cfg.freeze()
    return cfg


def jax_higher(use_scan: bool = False, joints: int = J,
               dtype=jnp.float32, extra=None):
    e = {**TINY_EXTRA, "NUM_BASIC_BLOCKS": BLOCKS, **(extra or {})}
    return JaxHigherHRNet(
        stage2_cfg=dict(e["STAGE2"]), stage3_cfg=dict(e["STAGE3"]),
        stage4_cfg=dict(e["STAGE4"]), num_joints=joints, tag_per_joint=True,
        num_deconv_filters=(FILTERS,), num_basic_blocks=e["NUM_BASIC_BLOCKS"],
        use_scan=use_scan, dtype=dtype)


def seeded_higher(seed: int = 0, size: int = SIZE, joints: int = J,
                  extra=None):
    """(port model in eval mode, '/'-joined JAX variables): seeded weights
    with BN statistics calibrated on seeded images, so every layer's
    output is O(1)."""
    model = get_pose_net(higher_cfg(size=size, joints=joints, extra=extra))
    flat = random_variables(variable_shapes(
        jax_higher(joints=joints, extra=extra), (size, size)), seed)
    calib = np.random.RandomState(seed + 6).randn(
        4, size, size, 3).astype(np.float32)
    flat = calibrate_bn(flat, model, calib)
    model.load_state_dict(jax_to_torch_state_dict(flat, model), strict=True)
    return model.eval(), flat


@pytest.fixture(scope="module")
def tiny():
    model, flat = seeded_higher()
    x = np.random.RandomState(1).randn(2, SIZE, SIZE, 3).astype(np.float32)
    return model, flat, x


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def test_registry_builds_higher_hrnet_with_tags_per_joint():
    model = get_pose_net(higher_cfg())
    assert isinstance(model, HigherHRNet) and not hasattr(model,
                                                          "final_layer")
    with torch.no_grad():
        outs = model(torch.zeros(1, 3, SIZE, SIZE))
    assert [tuple(o.shape) for o in outs] == [(1, 2 * J, 16, 16),
                                              (1, J, 32, 32)]


def test_eval_f32_matches_jax(tiny):
    model, flat, x = tiny
    want = jax_higher().apply(unflatten(flat), jnp.asarray(x), train=False)
    with torch.no_grad():
        got = model(_nchw(x))
    for g, w in zip(got, want):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert g.dtype == torch.float32 and np.abs(w).mean() > 0.05
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL,
                                   atol=ATOL * np.abs(w).max())


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_float64_matches_jax(tiny, mode):
    """Both heads, and in train mode the BN statistics it updates."""
    model, flat, x = tiny
    model = get_pose_net(higher_cfg()).double()
    model.load_state_dict(jax_to_torch_state_dict(flat, model))
    train = mode == "train"
    model.train(train)
    with enable_x64():
        v = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                         unflatten(flat))
        xj = jnp.asarray(x, jnp.float64)
        if train:
            want, mut = jax_higher(dtype=jnp.float64).apply(
                v, xj, train=True, mutable=["batch_stats"])
            want_stats = {k: np.asarray(a) for k, a in torch_leaves_of(
                mut["batch_stats"], "batch_stats").items()}
        else:
            want = jax_higher(dtype=jnp.float64).apply(v, xj, train=False)
        want = [np.asarray(w).transpose(0, 3, 1, 2) for w in want]
    with torch.no_grad():
        got = model(_nchw(x).double())
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-9 * np.abs(w).max())
    if train:
        back = torch_to_jax_leaves(model)
        for k, w in want_stats.items():
            np.testing.assert_allclose(back[k], w, rtol=0, atol=1e-9,
                                       err_msg=k)


def torch_leaves_of(tree, coll: str) -> dict:
    """{'<coll>/<leaf module>/<leaf>': array} of a JAX variable tree, the
    keys `torch_to_jax_leaves` gives."""
    import flax

    flat = flax.traverse_util.flatten_dict(flax.core.unfreeze(tree))
    return {f"{coll}/{k[-2]}/{k[-1]}": v for k, v in flat.items()}


def test_official_layout_state_dict_loads_strict():
    """A state dict in the official HigherHRNet torch layout loads into the
    port's model with strict=True and no remap, and gives the same outputs
    as the module that saved it."""
    torch.manual_seed(0)
    official = THigher().eval()
    _randomize(official)
    model = HigherHRNet(**OFFICIAL_STAGES, num_joints=OFFICIAL_J,
                        num_deconv_filters=(16,), num_basic_blocks=4)
    assert set(model.state_dict()) == set(official.state_dict())
    model.load_state_dict(official.state_dict(), strict=True)
    x = torch.randn(2, 3, 64, 64)
    with torch.no_grad():
        want = official(x)
        got = model.eval()(x)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * float(w.abs().max()))


@pytest.mark.parametrize("layout", ["unscanned", "scanned"])
def test_jax_variables_convert_without_leftovers(tiny, layout):
    """Every port key gets a JAX leaf and every JAX leaf is used; the
    scanned layout (the YAML's USE_SCAN) gives the same state dict."""
    model, flat, _ = tiny
    src = flat
    if layout == "scanned":
        src = to_scanned(flat, variable_shapes(jax_higher(use_scan=True),
                                               (SIZE, SIZE)))
        assert any("_scan/" in k for k in src)
    state = jax_to_torch_state_dict(src, get_pose_net(higher_cfg()))
    own = model.state_dict()
    assert set(state) == set(own)
    for k, v in own.items():
        if not k.endswith("num_batches_tracked"):  # a counter, no weight
            assert torch.equal(state[k], v), k
    with pytest.raises(KeyError):
        jax_to_torch_state_dict(
            {k: v for k, v in src.items() if "deconv_layers_0_bn" not in k},
            model)


def test_reverse_direction_gives_every_jax_leaf_back(tiny):
    model, flat, _ = tiny
    back = torch_to_jax_leaves(model)
    want = {f"{k.split('/')[0]}/{k.split('/')[-2]}/{k.split('/')[-1]}": v
            for k, v in flat.items()}
    assert set(back) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
