"""The traced window: `torch.profiler` over a few iterations, reduced to
host spans, device operations and the iteration each belongs to.

The benchmark names its own spans (`record_function`) around each call it
makes into the program: `pb.iter` around one iteration, and inside it
`pb.to_device`, `pb.prep`, `pb.step` and `pb.sync`. A device operation is
charged to the span in which the host launched it, found through the
launch's correlation id; what the program launches from a thread of its own
has no launching span and is charged to no span.

The program's own host events (`advmix_tpu_torch/utils/profiling.span` and
`count`: names that start with `advmix.`) that start inside a traced
`pb.iter` are kept apart: its spans in `Trace.program_spans`, its counters
in `Trace.counts`. They never enter `Trace.spans`, so a device operation is
still charged to a benchmark span and an idle gap still labelled by one;
`Trace.program_s` reads a program span's device and idle time.
"""

from __future__ import annotations

import bisect
import contextlib
import sys
from dataclasses import dataclass, field

import torch

# kernel-name fragments (lower case) -> family, first match wins: a copy of
# the program's `utils/profiling.FAMILIES`, so that the labels stay fixed
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

# the program's span names and, among them, its counters' (one zero-length
# span an event), as `advmix_tpu_torch/utils/profiling` writes them
PROGRAM = "advmix."
PROGRAM_COUNT = "advmix.count."

_LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")
_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset", "concurrent_kernel")


def _on_host(e) -> bool:
    return str(e.device_type()).endswith("CPU")


def _kind(e, host_names=frozenset()) -> str:
    """The activity kind of a profiler event: the event's own where this
    torch names it, else read from its device and name. A device event
    named as a host event is the device's copy of a `record_function`
    range (`Optimizer.step#Adam.step`, the benchmark's spans), not a
    kernel."""
    get = getattr(e, "activity_type", None)
    if get is not None:
        return get()
    name = e.name()
    if not _on_host(e):
        if name.startswith("pb.") or name in host_names:
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if name.startswith("pb."):
        return "user_annotation"
    if name.startswith("cu") and not name.startswith("cudnn"):
        return "cuda_runtime"
    return "cpu_op"


def family_of(name: str) -> str:
    n = name.lower()
    for key, fam in FAMILIES:
        if key in n:
            return fam
    return "other"


@dataclass
class DeviceOp:
    name: str
    kind: str
    start: int  # ns
    end: int
    span: str | None  # the benchmark span the host launched it from
    launch: int | None = None  # host time of the launch; None: not found


def _union(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


@dataclass
class Trace:
    """What a metric reader gets. Times are ns on the profiler's clock."""

    iters: list  # [(start, end)] of each traced `pb.iter`
    spans: dict  # span name -> [(start, end)]
    ops: list  # [DeviceOp], kernels and copies, in start order
    iter_s: list = field(default_factory=list)  # untraced iteration seconds
    flops_per_iter: float | None = None  # filled in lazily by the cell
    extra: dict = field(default_factory=dict)  # kind-specific numbers
    # the program's spans, `advmix.count.` events left out: name ->
    # [(start, end)]; and its counters: event name -> events
    program_spans: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)

    @property
    def n_iters(self) -> int:
        return len(self.iters)

    @property
    def window(self) -> tuple:
        return self.iters[0][0], self.iters[-1][1]

    @property
    def window_s(self) -> float:
        a, b = self.window
        return (b - a) * 1e-9

    def kernels(self):
        return [o for o in self.ops if o.kind in ("kernel",
                                                  "concurrent_kernel")]

    def busy_s(self) -> float:
        """Seconds of the window in which some device operation ran (the
        union of their intervals)."""
        a, b = self.window
        busy, cur_s, cur_e = 0, None, None
        for o in self.ops:
            s, e = max(o.start, a), min(o.end, b)
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy * 1e-9

    def device_s_in(self, span: str) -> float:
        return sum(o.end - o.start for o in self.ops if o.span == span) * 1e-9

    def host_s_in(self, *names) -> float:
        return sum(e - s for n in names for s, e in self.spans.get(n, ())) \
            * 1e-9

    def program_s(self, name: str) -> tuple:
        """(device seconds, idle seconds) of the program span `name`, its
        calls read as one union of intervals: the device time of the
        operations launched while it was open (a parent's holds its
        children's), and the part of its host time in which no device
        operation ran."""
        ivs = _union(self.program_spans.get(name, ()))
        starts = [s for s, _ in ivs]

        def inside(t):
            k = bisect.bisect_right(starts, t) - 1
            return k >= 0 and t < ivs[k][1]

        device = sum(o.end - o.start for o in self.ops
                     if o.launch is not None and inside(o.launch))
        busy = _union((o.start, o.end) for o in self.ops)
        b_starts = [a for a, _ in busy]
        cum = [0]
        for a, b in busy:
            cum.append(cum[-1] + b - a)

        def covered(s, e):
            i = bisect.bisect_right(b_starts, s) - 1  # the last to start <= s
            j = bisect.bisect_left(b_starts, e)  # i+1 .. j-1 start in (s, e)
            total = max(0, min(busy[i][1], e) - s) if i >= 0 else 0
            if j > i + 1:
                total += cum[j] - cum[i + 1] - max(0, busy[j - 1][1] - e)
            return total

        idle = sum((e - s) - covered(s, e) for s, e in ivs)
        return device * 1e-9, idle * 1e-9

    def gaps(self):
        """Idle gaps of the device inside the window: [(start, end)]."""
        a, b = self.window
        out, t = [], a
        for o in sorted(self.ops, key=lambda o: o.start):
            if o.start > t:
                out.append((t, min(o.start, b)))
            t = max(t, o.end)
            if t >= b:
                break
        if t < b:
            out.append((t, b))
        return [g for g in out if g[1] > g[0]]

    def span_at(self, t: int) -> str:
        best = None
        for name, ivs in self.spans.items():
            for s, e in ivs:
                if s <= t < e and (best is None or s > best[0]):
                    best = (s, name)
        return "outside the benchmark's spans" if best is None else best[1]

    def breakdown(self) -> dict:
        by_name: dict = {}
        for o in self.ops:
            by_name[o.name] = by_name.get(o.name, 0) + (o.end - o.start)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:10]
        return {"device_ops": [[f"{family_of(n)}: {n[:120]}", v * 1e-9]
                               for n, v in top],
                "idle_gaps": [[self.span_at(s), (e - s) * 1e-9]
                              for s, e in gaps]}


def span(name: str, on: bool):
    """A `record_function` span in a traced run; nothing otherwise."""
    if not on:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


class Profiler:
    """`torch.profiler` for iterations `skip` .. `skip + active - 1` of the
    window (the first `skip` run untraced, past the profiler's own start)."""

    def __init__(self, skip: int, active: int):
        from torch.profiler import ProfilerActivity, profile, schedule

        self.prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=max(skip - 1, 0), warmup=1, active=active,
                              repeat=1),
            record_shapes=False, with_stack=False)
        self.first = skip
        self.last = skip + active - 1

    def traced(self, i: int) -> bool:
        return self.first <= i <= self.last

    def __enter__(self):
        self.prof.__enter__()
        return self

    def step(self):
        self.prof.step()

    def __exit__(self, *exc):
        return self.prof.__exit__(*exc)

    def reduce(self) -> Trace:
        events = list(self.prof.profiler.kineto_results.events())
        spans: dict = {}
        iters = []
        launches = []  # (correlation id, host start)
        host_ops = {}  # cpu op correlation id -> start
        device = []
        program = []  # (name, start, end) of the program's host events
        kinds: dict = {}
        host_names = frozenset(e.name() for e in events if _on_host(e))
        for e in events:
            kind = _kind(e, host_names)
            kinds[kind] = kinds.get(kind, 0) + 1
            if e.name().startswith(PROGRAM) and _on_host(e):
                program.append((e.name(), e.start_ns(),
                                e.start_ns() + e.duration_ns()))
            if kind == "user_annotation" and e.name().startswith("pb."):
                iv = (e.start_ns(), e.start_ns() + e.duration_ns())
                if e.name() == "pb.iter":
                    iters.append(iv)
                else:
                    spans.setdefault(e.name(), []).append(iv)
            elif kind in _LAUNCH_KINDS:
                launches.append((e.correlation_id(), e.start_ns()))
            elif kind == "cpu_op":
                host_ops[e.correlation_id()] = e.start_ns()
            elif kind in _DEVICE_KINDS:
                device.append(e)
        iters.sort()
        launch_at = dict(launches)
        bounds = sorted((s, e, n) for n, ivs in spans.items()
                        for s, e in ivs)
        starts = [b[0] for b in bounds]

        def span_of(t):
            if t is None:
                return None
            k = bisect.bisect_right(starts, t) - 1
            while k >= 0:
                s, e, n = bounds[k]
                if s <= t < e:
                    return n
                if t - s > 10 ** 10:
                    break
                k -= 1
            return None

        ops = []
        for e in device:
            t = launch_at.get(e.correlation_id())
            if t is None:
                t = host_ops.get(e.linked_correlation_id())
            start = e.start_ns()
            ops.append(DeviceOp(e.name(), _kind(e, host_names), start,
                                start + e.duration_ns(), span_of(t), t))
        ops.sort(key=lambda o: o.start)
        it_starts = [s for s, _ in iters]

        def traced(t):
            k = bisect.bisect_right(it_starts, t) - 1
            return k >= 0 and t < iters[k][1]

        program_spans, counts = {}, {}
        for name, s, e in program:
            if not traced(s):
                continue
            if name.startswith(PROGRAM_COUNT):
                counts[name] = counts.get(name, 0) + 1
            else:
                program_spans.setdefault(name, []).append((s, e))
        print(f"[portbench] trace: {len(iters)} iterations, {len(ops)} device"
              f" operations, {sum(o.span is not None for o in ops)} charged "
              f"to a span; events by kind {kinds}; program spans "
              f"{sum(map(len, program_spans.values()))}, counts {counts}",
              file=sys.stderr, flush=True)
        return Trace(iters=iters, spans=spans, ops=ops,
                     program_spans=program_spans, counts=counts)
