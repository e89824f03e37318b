"""Optimizers and the learning-rate schedule.

Port of `advmix_tpu/engine/optim.py` (reference `lib/utils/utils.py:78-94`:
SGD with momentum, weight decay and Nesterov, or plain Adam at TRAIN.LR;
HRFormer's AdamW, decoupled weight decay TRAIN.WD, for `adamw`; and
the per-epoch MultiStepLR of `tools/train.py:272-281`, factor
TRAIN.LR_FACTOR at the epochs TRAIN.LR_STEP). The host writes the rate into
the optimizer's `param_groups` once per epoch, so a resume recomputes it
from the epoch alone.
"""

from __future__ import annotations

import torch


def multistep_lr(base_lr: float, lr_step, lr_factor: float,
                 epoch: int) -> float:
    """MultiStepLR value at `epoch` (0-based, as torch's last_epoch)."""
    lr = base_lr
    for milestone in sorted(lr_step):
        if epoch >= milestone:
            lr *= lr_factor
    return lr


def get_optimizer(cfg, params) -> torch.optim.Optimizer:
    """The pose network's optimizer from cfg.TRAIN. Every parameter must
    be f32: under bf16 the master weights stay f32
    (`models.layers.set_compute_dtype(..., trainable=True)`)."""
    params = [p for p in params if p.requires_grad]
    bad = {p.dtype for p in params} - {torch.float32, torch.float64}
    if bad:
        raise TypeError(f"trainable parameters of dtype {sorted(map(str, bad))}"
                        ": the optimizer updates f32 master weights only")
    if cfg.TRAIN.OPTIMIZER == "sgd":
        # torch adds the weight decay to the gradient before the momentum
        # buffer, as the JAX package's chain does
        momentum = float(cfg.TRAIN.MOMENTUM)
        return torch.optim.SGD(
            params, lr=cfg.TRAIN.LR, momentum=momentum,
            weight_decay=cfg.TRAIN.WD,
            nesterov=bool(cfg.TRAIN.NESTEROV) and momentum > 0)
    if cfg.TRAIN.OPTIMIZER == "adam":
        return torch.optim.Adam(params, lr=cfg.TRAIN.LR)
    if cfg.TRAIN.OPTIMIZER == "adamw":
        # capturable as Adam is (engine/steps.make_capturable_)
        return torch.optim.AdamW(params, lr=cfg.TRAIN.LR,
                                 weight_decay=cfg.TRAIN.WD)
    raise ValueError(f"unknown optimizer {cfg.TRAIN.OPTIMIZER}")


def get_generator_optimizer(cfg, params) -> torch.optim.Optimizer:
    """G's optimizer is built as D's is (`tools/train.py:186`)."""
    return get_optimizer(cfg, params)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def epoch_lr_update(optimizer: torch.optim.Optimizer, cfg,
                    epoch: int) -> float:
    lr = multistep_lr(cfg.TRAIN.LR, list(cfg.TRAIN.LR_STEP),
                      cfg.TRAIN.LR_FACTOR, epoch)
    set_learning_rate(optimizer, lr)
    return lr
