"""Model summary: parameters and FLOPs.

Counterpart of `advmix_tpu/utils/summary.py` (the reference's
`get_model_summary`, lib/utils/utils.py:110-242). The JAX package reads
XLA's cost model; here `torch.utils.flop_counter.FlopCounterMode` counts the
FLOPs of the matrix products and convolutions of one forward (2 per
multiply-add over every tap of each window) and nothing elementwise. XLA
skips the taps that fall on a convolution's zero padding and counts the
elementwise ops, so the two differ most on small maps (PoseResNet-18:
this count 1.30x XLA's at 64x64, 1.064x at 256x256). PyTorch has no cost
model of the bytes a program moves: `bytes_accessed_per_batch` is None.
"""

from __future__ import annotations

import copy

import torch
from torch.utils.flop_counter import FlopCounterMode


def _stats_of(model) -> int:
    """BatchNorm running mean and variance: the JAX `batch_stats`."""
    return sum(b.numel() for m in model.modules()
               if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
               and m.track_running_stats
               for b in (m.running_mean, m.running_var))


def _count(model, sample_input, train: bool) -> FlopCounterMode:
    """One forward of a copy of `model` (train mode would update the BN
    statistics) under the FLOP counter."""
    m = copy.deepcopy(model).train(train)
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        m(sample_input)
    return counter


def model_summary(model, sample_input, train: bool = False) -> dict:
    """{"params", "batch_stats", "flops_per_batch",
    "bytes_accessed_per_batch"} of `model` on `sample_input` (one batch)."""
    return {
        "params": sum(p.numel() for p in model.parameters()),
        "batch_stats": _stats_of(model),
        "flops_per_batch": _count(model, sample_input, train)
        .get_total_flops(),
        "bytes_accessed_per_batch": None,
    }


def per_layer_summary(model, sample_input, train: bool = False,
                      depth: int = 3) -> str:
    """A per-module table of parameters and forward FLOPs down to `depth`
    levels below the model (the reference emits it per layer from forward
    hooks; the JAX package through `nn.tabulate`)."""
    flops = _count(model, sample_input, train).get_flop_counts()
    modules = dict(model.named_modules())
    root = type(model).__name__
    rows = []
    for name, per_op in flops.items():
        if name == "Global":
            continue
        path = name[len(root) + 1:] if name.startswith(root + ".") else ""
        if name != root and not path:
            continue  # another tracker root
        if path.count(".") >= depth or path not in modules:
            continue
        n_params = sum(p.numel() for p in modules[path].parameters())
        rows.append((path or root, n_params, sum(per_op.values())))
    width = max([len(r[0]) for r in rows] + [6])
    lines = [f"{'module':{width}s} {'params':>12s} {'GFLOPs':>10s}"]
    lines += [f"{p:{width}s} {n:12,d} {f / 1e9:10.4f}" for p, n, f in rows]
    return "\n".join(lines)


def format_summary(info: dict, name: str = "model") -> str:
    lines = [f"=> {name} summary"]
    lines.append(f"   params: {info['params'] / 1e6:.2f}M")
    if info.get("flops_per_batch"):
        lines.append(f"   fwd FLOPs/batch: {info['flops_per_batch'] / 1e9:.2f}G")
    if info.get("bytes_accessed_per_batch"):
        lines.append(
            f"   bytes accessed/batch: {info['bytes_accessed_per_batch'] / 1e9:.2f}GB"
        )
    return "\n".join(lines)
