"""Model registry, initialization and weight loading.

Port of `advmix_tpu/models/__init__.py` for the top-down models. The
reference resolves architectures with `eval('models.'+cfg.MODEL.NAME+...)`
(`tools/train.py:60`); here an explicit registry does.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from . import pose_hrnet, pose_resnet
from .convert import jax_to_torch_state_dict

_REGISTRY = {
    "pose_resnet": pose_resnet.get_pose_net,
    "pose_hrnet": pose_hrnet.get_pose_net,
}


def get_pose_net(cfg) -> nn.Module:
    """An f32 model on the CPU, initialized as the reference does
    (`lib/models/pose_hrnet.py:462`): convs ~ N(0, 0.001), biases 0, BN
    scale 1, shift 0 (the draws come from a seeded generator)."""
    name = cfg.MODEL.NAME
    if name not in _REGISTRY:
        raise KeyError(f"unknown model '{name}'; available: {list(_REGISTRY)}")
    model = _REGISTRY[name](cfg)
    gen = torch.Generator().manual_seed(0)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            with torch.no_grad():
                m.weight.normal_(0.0, 0.001, generator=gen)
                if m.bias is not None:
                    m.bias.zero_()
    return model


def he_reinit_convs(model: nn.Module, generator: torch.Generator) -> None:
    """He-normal re-initialization of every conv kernel (counterpart of
    `advmix_tpu/models/__init__.py:he_reinit_convs`), so a random model's
    outputs are O(1) instead of ~0."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight
            fan_in = w.shape[1] * w.shape[2] * w.shape[3]
            with torch.no_grad():
                w.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)


def strip_module_prefix(state_dict: dict) -> dict:
    """Remove DataParallel 'module.' prefixes (`tools/train.py:201`)."""
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in state_dict.items()}


def load_model_file(model: nn.Module, path: str) -> None:
    """Load a reference `.pth` (optionally wrapped in {'state_dict': ...},
    with 'module.' prefixes) or an `.npz` of JAX variables flattened to
    '/'-joined paths (`models/convert.py`) into `model`, strictly."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
        state = jax_to_torch_state_dict(flat, model)
    else:
        state = torch.load(path, map_location="cpu")
        if isinstance(state, dict) and "state_dict" in state:
            state = state["state_dict"]
        state = strip_module_prefix(state)
        # checkpoints saved before torch tracked BN batch counts lack
        # these counters; they carry no weights, so keep the model's own
        for k, v in model.state_dict().items():
            if k.endswith("num_batches_tracked"):
                state.setdefault(k, v)
    model.load_state_dict(state, strict=True)
