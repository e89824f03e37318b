"""Profiling and tracing.

Counterpart of `advmix_tpu/utils/profiling.py` (the reference's forward-hook
FLOPs profiler and AverageMeter timers, `lib/utils/utils.py:110-242`):

- `trace(logdir)`: a `torch.profiler` context that writes a Chrome trace
  of the host's operators and, on a card, its kernels;
- `StepTimer`: a step / images-per-second meter that synchronises with the
  card before it reads the clock;
- `family_of` / `by_family`: the coarse kernel families that
  `chip_smoke.py` and `tools/profile.py` tabulate device time by;
- `model_summary` (utils/summary.py): parameters and FLOPs.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.utils._pytree import tree_leaves


@contextlib.contextmanager
def trace(logdir: str, enabled: bool = True):
    """`torch.profiler` over the block, written to `<logdir>/trace.json`
    (a Chrome trace) when it ends; a no-op when disabled. Operators keep
    their input shapes and FLOPs, which `tools/profile.analyze_kernels`
    charges to their kernels. Yields the profiler (None when disabled)."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts, record_shapes=True,
                 with_flops=True) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """Throughput meter: call tick(n_images) after each step. `sync`, a
    tensor (or a structure of them) the step produced, makes the tick wait
    for the card that holds it first, so the clock reads real completion,
    not the end of the launches."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.count = 0
        self.images = 0
        self._t0 = None

    def tick(self, n_images: int, sync=None):
        if sync is not None:
            for t in tree_leaves(sync):
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    torch.cuda.synchronize(t.device)
        self.count += 1
        if self.count == self.warmup:
            self._t0 = time.perf_counter()
            self.images = 0
        elif self.count > self.warmup:
            self.images += n_images

    @property
    def img_per_sec(self) -> float:
        if self._t0 is None or self.images == 0:
            return 0.0
        return self.images / (time.perf_counter() - self._t0)


# kernel-name fragments (lower case) -> family, first match wins
FAMILIES = (("batch_norm", "batch norm"), ("batchnorm", "batch norm"),
            ("bn_fw", "batch norm"), ("bn_bw", "batch norm"),
            ("wgrad", "conv wgrad"), ("dgrad", "conv dgrad"),
            ("gemm", "conv/gemm"), ("conv", "conv/gemm"),
            ("cutlass", "conv/gemm"), ("xmma", "conv/gemm"),
            ("copy", "dtype cast / copy"), ("scatter", "scatter/gather"),
            ("gather", "scatter/gather"),
            ("multi_tensor", "optimizer (foreach)"),
            ("upsample", "upsample"), ("reduce", "reduce"),
            ("elementwise", "elementwise"))


def family_of(kernel_name: str) -> str:
    """A coarse family for a profiler kernel name."""
    n = kernel_name.lower()
    for key, fam in FAMILIES:
        if key in n:
            return fam
    return "other"


def by_family(by_name: dict) -> dict:
    """{kernel name: (us, launches)} summed into {family: (us, launches)},
    the largest first."""
    fams: dict = {}
    for name, (t, n) in by_name.items():
        ft, fn = fams.get(family_of(name), (0.0, 0))
        fams[family_of(name)] = (ft + t, fn + n)
    return dict(sorted(fams.items(), key=lambda kv: -kv[1][0]))
