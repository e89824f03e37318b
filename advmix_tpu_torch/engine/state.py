"""Train state: the models, their optimizers and the step count.

Counterpart of `advmix_tpu/engine/state.py`. The JAX package's states are
immutable pytrees that a step maps to new ones; here a state owns modules
and optimizers, and a step mutates them.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import torch
from torch import nn

from ..models.layers import set_compute_dtype
from . import optim


@dataclass
class PoseState:
    """Standard training: one pose network and its optimizer."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


@dataclass
class AdvMixState:
    """AdvMix min-max training: D (the pose network), G (the UNet
    generator) and the teacher, a frozen copy of D in eval mode that gives
    the KD target: the three models of the reference's `tools/train.py:64-69`."""

    model_d: nn.Module
    optimizer_d: torch.optim.Optimizer
    model_g: nn.Module
    optimizer_g: torch.optim.Optimizer
    teacher: nn.Module
    step: int = 0


def make_teacher(model_d: nn.Module,
                 dtype: torch.dtype = torch.float32) -> nn.Module:
    """A deep copy of D, frozen, in eval mode, computing in `dtype`."""
    teacher = copy.deepcopy(model_d).eval()
    return set_compute_dtype(teacher, dtype, trainable=False)


def create_pose_state(cfg, model: nn.Module, device: torch.device,
                      dtype: torch.dtype = torch.float32) -> PoseState:
    model = set_compute_dtype(model.to(device), dtype, trainable=True)
    return PoseState(model, optim.get_optimizer(cfg, model.parameters()))


def create_advmix_state(cfg, model_d: nn.Module, model_g: nn.Module,
                        device: torch.device,
                        dtype: torch.dtype = torch.float32) -> AdvMixState:
    """The teacher starts as a copy of D as it is handed in, so load D's
    fine-tune weights before this call (`tools/train.py:65`)."""
    model_d = model_d.to(device)
    teacher = make_teacher(model_d, dtype)
    model_d = set_compute_dtype(model_d, dtype, trainable=True)
    model_g = set_compute_dtype(model_g.to(device), dtype, trainable=True)
    return AdvMixState(
        model_d, optim.get_optimizer(cfg, model_d.parameters()),
        model_g, optim.get_generator_optimizer(cfg, model_g.parameters()),
        teacher)
