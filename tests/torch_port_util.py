"""Shared fixtures of the port's tests (tests/test_torch_*.py): a tiny HRNet
config, seeded JAX variables for it in both weight layouts, and the
'/'-joined flattening that `advmix_tpu_torch.models.convert` reads."""

from __future__ import annotations

import flax
import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_dist_worker import stdlib_profile

# bind the standard library's cProfile and profile while the port's test
# files are collected, before any test runs: torch imports them only with
# `torch._dynamo`, at a process's first custom-op call, and by then a
# JAX-package test may have left `tools/` (and its profile.py) at the head
# of sys.path (tests/test_misc_paths.py does)
with stdlib_profile():
    import cProfile  # noqa: F401

# the W32 topology at narrow widths; stage 3's two modules and the two
# blocks per branch make the scanned layout differ from the unscanned one
TINY_EXTRA = dict(
    FINAL_CONV_KERNEL=1,
    STAGE2=dict(NUM_MODULES=1, NUM_BRANCHES=2, BLOCK="BASIC",
                NUM_BLOCKS=[2, 2], NUM_CHANNELS=[4, 8], FUSE_METHOD="SUM"),
    STAGE3=dict(NUM_MODULES=2, NUM_BRANCHES=3, BLOCK="BASIC",
                NUM_BLOCKS=[2, 2, 2], NUM_CHANNELS=[4, 8, 16],
                FUSE_METHOD="SUM"),
    STAGE4=dict(NUM_MODULES=1, NUM_BRANCHES=4, BLOCK="BASIC",
                NUM_BLOCKS=[2, 2, 2, 2], NUM_CHANNELS=[4, 8, 16, 32],
                FUSE_METHOD="SUM"),
)
# (w, h): HRNet's four branches need the heatmap divisible by 8
TINY_IMAGE = [32, 64]
TINY_HEATMAP = [8, 16]


def tiny_cfg(load_config, **test):
    """A frozen config of either package for the tiny top-down HRNet."""
    cfg = load_config()
    cfg.defrost()
    cfg.MODEL.NAME = "pose_hrnet"
    cfg.MODEL.NUM_JOINTS = 17
    cfg.MODEL.IMAGE_SIZE = list(TINY_IMAGE)
    cfg.MODEL.HEATMAP_SIZE = list(TINY_HEATMAP)
    cfg.MODEL.EXTRA = {k: (dict(v) if isinstance(v, dict) else v)
                       for k, v in TINY_EXTRA.items()}
    for k, v in test.items():
        cfg.TEST[k] = v
    cfg.freeze()
    return cfg


def jax_hrnet(extra: dict, num_joints: int = 17, use_scan: bool = False):
    from advmix_tpu.models.pose_hrnet import PoseHighResolutionNet

    return PoseHighResolutionNet(
        stage2_cfg=dict(extra["STAGE2"]), stage3_cfg=dict(extra["STAGE3"]),
        stage4_cfg=dict(extra["STAGE4"]), num_joints=num_joints,
        final_conv_kernel=extra["FINAL_CONV_KERNEL"], use_scan=use_scan)


def variable_shapes(model, image_hw) -> dict:
    """{'/'-joined path: ShapeDtypeStruct} of model.init, without compiling."""
    x = jnp.zeros((1, image_hw[0], image_hw[1], 3), jnp.float32)
    tree = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), x, train=False))
    flat = flax.traverse_util.flatten_dict(flax.core.unfreeze(tree))
    return {"/".join(k): v for k, v in flat.items()}


def random_variables(shapes: dict, seed: int) -> dict:
    """Seeded numpy values for unscanned variables: He-normal conv kernels
    (as `advmix_tpu.models.he_reinit_convs`), BN scale/shift and running
    stats near identity, so a narrow net's outputs are O(1)."""
    rng = np.random.RandomState(seed)
    out = {}
    for path in sorted(shapes):
        shape = shapes[path].shape
        leaf = path.rsplit("/", 1)[1]
        if leaf == "kernel":
            v = rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[:3]))
        elif leaf == "scale":
            v = 1.0 + 0.1 * rng.randn(*shape)
        elif leaf in ("bias", "mean"):
            v = 0.1 * rng.randn(*shape)
        elif leaf == "var":
            v = rng.uniform(0.5, 1.5, shape)
        else:
            raise KeyError(path)
        out[path] = v.astype(np.float32)
    return out


def calibrate_bn(flat: dict, port_model, x_nhwc: np.ndarray) -> dict:
    """Replace the unscanned variables' BN running stats by the batch
    statistics of `x_nhwc` through the port's model, so activations stay
    O(1) through a deep random net; both packages then run the same stats.
    Variances are floored at 1: a channel nearly dead on the calibration
    batch would otherwise amplify the f32 rounding of everything after
    it (with a floor of 1e-2 the tiny HRNet's own f32 and f64 forwards
    differ by 1e-5 of the output's range, with 1 by 1e-6)."""
    from advmix_tpu_torch.models.convert import flax_module_name, \
        jax_to_torch_state_dict

    port_model.load_state_dict(jax_to_torch_state_dict(flat, port_model))
    bns = {n: m for n, m in port_model.named_modules()
           if isinstance(m, torch.nn.BatchNorm2d)}
    for m in bns.values():
        m.reset_running_stats()
        m.momentum = None
    port_model.train()
    with torch.no_grad():
        port_model(torch.from_numpy(
            np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2))))
    prefix = {k.rsplit("/", 2)[1]: k.rsplit("/", 1)[0]
              for k in flat if k.startswith("batch_stats/")}
    out = dict(flat)
    for name, m in bns.items():
        p = prefix[flax_module_name(name)]
        out[p + "/mean"] = m.running_mean.numpy().astype(np.float32)
        out[p + "/var"] = m.running_var.clamp(min=1.0).numpy().astype(
            np.float32)
    port_model.eval()
    return out


def to_scanned(flat_unscanned: dict, scanned_shapes: dict) -> dict:
    """Restack unscanned '/'-joined variables into the scanned layout with
    the JAX package's own `stack_for_scan`."""
    from advmix_tpu.models.torch_convert import stack_for_scan

    out = {}
    for coll in ("params", "batch_stats"):
        un = unflatten({k: v for k, v in flat_unscanned.items()
                        if k.startswith(coll + "/")})[coll]
        tmpl = unflatten({k: np.zeros(s.shape, s.dtype)
                          for k, s in scanned_shapes.items()
                          if k.startswith(coll + "/")})[coll]
        stacked = stack_for_scan(un, tmpl)
        out.update({f"{coll}/" + "/".join(k): np.asarray(v) for k, v in
                    flax.traverse_util.flatten_dict(stacked).items()})
    return out


def unflatten(flat: dict) -> dict:
    return flax.traverse_util.unflatten_dict(
        {tuple(k.split("/")): v for k, v in flat.items()})
