"""Profiling and tracing.

Counterpart of `advmix_tpu/utils/profiling.py` (the reference's forward-hook
FLOPs profiler and AverageMeter timers, `lib/utils/utils.py:110-242`):

- `trace(logdir)`: a `torch.profiler` context that writes a Chrome trace
  of the host's operators and, on a card, its kernels;
- `span(name)` / `count(name)`: the program's own ranges and events in
  whatever profiler is recording, free of the profiler's cost when none
  is; `phase_rows` reads them back against the device's operations;
- `family_of` / `by_family`: the coarse kernel families that
  `chip_smoke.py` and `tools/profile.py` tabulate device time by;
- `model_summary` (utils/summary.py): parameters and FLOPs.
"""

from __future__ import annotations

import bisect
import contextlib
import os

import torch


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


# the program's spans: every name starts with PREFIX; `count(name)` records
# a zero-length span COUNT_PREFIX + name
PREFIX = "advmix."
COUNT_PREFIX = "advmix.count."
_OFF = contextlib.nullcontext()


def span(name: str):
    """`with span("advmix.<phase>"):` around a phase of the program: a
    `record_function` range while a torch profiler records (the benchmark's
    `--trace 1`, `tools/profile`, any `torch.profiler.profile`), a shared
    no-op context otherwise. On a CPU host the gate costs ~1 us a call, an
    ungated `record_function` ~11 us with nothing recording."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


def count(name: str) -> None:
    """One zero-length span `advmix.count.<name>` while a profiler records:
    an event to count (a constant built, a collective called)."""
    if torch.autograd._profiler_enabled():
        with torch.profiler.record_function(COUNT_PREFIX + name):
            pass


def _union(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class _Covered:
    """Length of [s, e) that a union of intervals covers, by bisection."""

    def __init__(self, merged):
        self.merged = merged
        self.starts = [m[0] for m in merged]
        self.cum = [0]
        for a, b in merged:
            self.cum.append(self.cum[-1] + b - a)

    def __call__(self, s, e) -> float:
        m = self.merged
        i = bisect.bisect_right(self.starts, s) - 1  # the last to start <= s
        j = bisect.bisect_left(self.starts, e)  # those from i+1 start < e
        total = max(0, min(m[i][1], e) - s) if i >= 0 else 0
        if j > i + 1:
            total += self.cum[j] - self.cum[i + 1] - max(0, m[j - 1][1] - e)
        return total


def phase_rows(spans, ops, n_iters: int, ms_per_unit: float) -> list:
    """Per program span name, per iteration: (name, calls, host ms, device
    ms, idle ms, device operations), in the order the names first start.

    `spans`: (name, start, end) of the `advmix.*` ranges on the host;
    `ops`: (launch, start, end) of each device operation, `launch` the host
    time of the call that launched it (None: charged to no span). Times
    share one clock, in units of `ms_per_unit` ms. A span is read as the
    union of its intervals (nested calls of one name count once); an
    operation is charged to every span whose union holds its launch, so a
    parent's device time holds its children's, and a kernel that autograd's
    backward thread launches is charged by time to the phase the main
    thread is in. Idle: the part of the span's host time in which no
    device operation ran."""
    if n_iters <= 0:
        return []
    ivs: dict = {}
    for name, s, e in sorted(spans, key=lambda x: (x[1], -x[2])):
        ivs.setdefault(name, []).append((s, e))
    busy = _Covered(_union((s, e) for _, s, e in ops))
    charged = sorted((t, e - s) for t, s, e in ops if t is not None)
    at = [c[0] for c in charged]
    cum = [0]
    for _, d in charged:
        cum.append(cum[-1] + d)
    rows = []
    for name, raw in ivs.items():
        host = dev = idle = n = 0
        for s, e in _union(raw):
            a, b = bisect.bisect_left(at, s), bisect.bisect_left(at, e)
            host += e - s
            dev += cum[b] - cum[a]
            n += b - a
            idle += (e - s) - busy(s, e)
        k = ms_per_unit / n_iters
        rows.append((name, len(raw) / n_iters, host * k, dev * k, idle * k,
                     n / n_iters))
    return rows


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
