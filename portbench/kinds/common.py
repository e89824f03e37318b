"""Pieces the kinds share: the seeded weights handed to both sides, the
program's models built without their host-side initialization, and the
numbers of the output check."""

from __future__ import annotations

import importlib

import torch

from .. import inputs
from ..reference import models, numerics


def dtype_of(cfg) -> torch.dtype:
    return torch.bfloat16 if str(cfg.TRAIN.DTYPE) == "bfloat16" \
        else torch.float32


def reference_pose(model_cfg: dict, device) -> torch.nn.Module:
    with torch.device(device):
        return models.pose_net(model_cfg)


def seeded_weights(model_cfg: dict, image_size, seed: int, device,
                   with_generator: bool) -> dict:
    """{"d": state dict, "g": state dict or None} on the host: He-normal
    weights from the seed, D's BatchNorm statistics from 16 seeded images
    (through the f32 reference, TF32 off)."""
    w, h = image_size
    d = reference_pose(model_cfg, device)
    inputs.he_init_(d, inputs.device_gen(seed, 4, device),
                    inputs.device_gen(seed, 7, device))
    calib = inputs.normalized(inputs.smooth_images(
        16, h, w, inputs.device_gen(seed, 6, device), device))
    with numerics.exact_f32():
        inputs.calibrate_bn_(d, calib)
    out = {"d": {k: v.detach().cpu() for k, v in d.state_dict().items()},
           "g": None}
    if with_generator:
        with torch.device(device):
            g = models.Unet()
        inputs.he_init_(g, inputs.device_gen(seed, 5, device),
                        inputs.device_gen(seed, 8, device))
        out["g"] = {k: v.detach().cpu() for k, v in g.state_dict().items()}
    return out


def port_pose(cfg, state: dict, device) -> torch.nn.Module:
    """The program's pose network of cfg.MODEL.NAME, made on the meta
    device (no host initialization) and given `state`."""
    name = cfg.MODEL.NAME
    mod = importlib.import_module(f"advmix_tpu_torch.models.{name}")
    with torch.device("meta"):
        m = mod.get_pose_net(cfg)
    prog, ref = set(m.state_dict()), set(state)
    if prog != ref:
        raise KeyError(
            f"the reference of {name} and the program's get_pose_net name "
            f"their state differently: reference only "
            f"{sorted(ref - prog)[:8]}, program only {sorted(prog - ref)[:8]}")
    m = m.to_empty(device=device)
    m.load_state_dict(state, strict=True)
    return m


def port_generator(state: dict, device) -> torch.nn.Module:
    from advmix_tpu_torch.models.unet import UnetGenerator

    with torch.device("meta"):
        g = UnetGenerator(input_nc=9, output_nc=3, num_downs=6, ngf=64)
    g = g.to_empty(device=device)
    g.load_state_dict(state, strict=True)
    return g


def sample(n_total: int, k: int, seed: int) -> list:
    """`k` distinct indices of range(n_total) drawn from the seed, sorted."""
    g = torch.Generator().manual_seed(inputs.sub_seed(seed, 9))
    return sorted(torch.randperm(n_total, generator=g)[:k].tolist())
