"""Model registry, initialization and weight loading.

Port of `advmix_tpu/models/__init__.py`. The
reference resolves architectures with `eval('models.'+cfg.MODEL.NAME+...)`
(`tools/train.py:60`); here an explicit registry does.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from . import higher_hrnet, pose_hrformer, pose_hrnet, pose_resnet
from .convert import jax_to_torch_state_dict, jax_unet_to_torch_state_dict
from .unet import UnetGenerator, get_generator  # noqa: F401

_REGISTRY = {
    "pose_resnet": pose_resnet.get_pose_net,
    "pose_hrnet": pose_hrnet.get_pose_net,
    "pose_higher_hrnet": higher_hrnet.get_pose_net,
    "pose_hrformer": pose_hrformer.get_pose_net,
}

TABLE_STD = 0.02  # linears and bias tables: truncated N(0, 0.02) at 2 std


def get_pose_net(cfg) -> nn.Module:
    """An f32 model on the CPU, initialized as the reference does
    (`lib/models/pose_hrnet.py:462`): convs ~ N(0, 0.001), biases 0, BN
    scale 1, shift 0; then, as HRFormer and ViT start them, linear weights
    and every other free parameter (the attention's bias tables) truncated
    N(0, 0.02) at two standard deviations, linear biases 0, LayerNorm
    scale 1 and shift 0. All draws come from one seeded generator, the
    convolutions' first, so a model of convolutions alone draws as
    before."""
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
    _init_rest_(model, gen)
    return model


def _init_rest_(model: nn.Module, gen: torch.Generator) -> None:
    """Every parameter not in a convolution or a norm, in parameter order:
    linear weights and free tables ~ truncated N(0, TABLE_STD); linear
    biases 0."""
    skip = set()
    for m in model.modules():
        own = list(m.parameters(recurse=False))
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.LayerNorm,
                          nn.modules.batchnorm._NormBase)):
            skip.update(map(id, own))
        elif isinstance(m, nn.Linear) and m.bias is not None:
            skip.add(id(m.bias))
            with torch.no_grad():
                m.bias.zero_()
    with torch.no_grad():
        for p in model.parameters():
            if id(p) not in skip:
                nn.init.trunc_normal_(p, std=TABLE_STD, a=-2 * TABLE_STD,
                                      b=2 * TABLE_STD, generator=gen)


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


def _read_state_dict(path: str) -> dict:
    state = torch.load(path, map_location="cpu")
    for wrapper in ("state_dict", "best_state_dict"):
        if isinstance(state, dict) and wrapper in state:
            state = state[wrapper]
    return strip_module_prefix(state)


def load_pretrained(model: nn.Module, path: str, layers=("*",)) -> int:
    """Selective, shape-filtered init from a backbone `.pth`
    (`lib/models/pose_hrnet.py:462-492`): a key is taken when its first
    component is in `layers` (or `layers` holds '*'), the model has it and
    the shapes agree. Returns the number of keys taken; raises at 0."""
    own = model.state_dict()
    layers = tuple(layers or ("*",))
    take = {k: v for k, v in _read_state_dict(path).items()
            if (layers[0] == "*" or k.split(".")[0] in layers)
            and k in own and tuple(v.shape) == tuple(own[k].shape)}
    if not take:
        raise KeyError(f"{path}: no key matches the model")
    model.load_state_dict(take, strict=False)
    return len(take)


def load_generator_file(model: UnetGenerator, path: str) -> None:
    """Load a reference `UnetGenerator` `.pth` or an `.npz` of the flax G's
    params ('/'-joined paths) into the port's G, strictly."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            state = jax_unet_to_torch_state_dict(
                {k: z[k] for k in z.files}, model)
    else:
        state = _read_state_dict(path)
    model.load_state_dict(state, strict=True)


def load_model_file(model: nn.Module, path: str) -> None:
    """Load a reference `.pth` (optionally wrapped in {'state_dict': ...},
    with 'module.' prefixes), the port's own `final_state` or
    `model_best.pth`, or an `.npz` of JAX variables flattened to '/'-joined
    paths (`models/convert.py`) into `model`, strictly."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
        state = jax_to_torch_state_dict(flat, model)
    else:
        state = _read_state_dict(path)
        # checkpoints saved before torch tracked BN batch counts lack
        # these counters; they carry no weights, so keep the model's own
        for k, v in model.state_dict().items():
            if k.endswith("num_batches_tracked"):
                state.setdefault(k, v)
    model.load_state_dict(state, strict=True)
