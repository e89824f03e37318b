"""The program's own spans in one traced cell of the benchmark.

    python3 -m portbench.phases --workload <cell> --seed <n> \
        --seconds <s> --trace 1 [--out <file.json>]

Runs the cell as `portbench.run` does, its result line included, and after
the traced window reads the program's `advmix.*` spans and
`advmix.count.*` events (`advmix_tpu_torch/utils/profiling.span` and
`count`) from the same profiler's events: per traced iteration each
span's calls, host ms, device ms and idle ms
(`advmix_tpu_torch/utils/profiling.phase_rows`), the step's phases' device
ms summed against the device ms of `pb.step`, and the window's ten longest
idle gaps labelled `<benchmark span> > <innermost program span>`. Prints
one JSON line on standard error after `[phases] `, and writes it to
`--out` where one is given. No metric of `BENCHMARK.json` reads it: the
`Trace` that `portbench/trace.py` hands the metric readers keeps the
benchmark's own `pb.*` spans only.
"""

from __future__ import annotations

import bisect
import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

# the phases that split the step's device time, per kind of cell
PARTS = {"train": ("advmix.generate", "advmix.teacher", "advmix.d_update",
                   "advmix.g_update", "advmix.metrics"),
         "eval": ("advmix.eval_forward", "advmix.eval_score",
                  "advmix.eval_decode")}


def _innermost(spans):
    """t -> the innermost program span (not a count event) open at time t,
    or None: the change points of a stack of open spans."""
    from advmix_tpu_torch.utils.profiling import COUNT_PREFIX

    marks = []
    for n, s, e in spans:
        if not n.startswith(COUNT_PREFIX):
            marks += [(s, 1, -e, n), (e, 0, 0, n)]
    times, names, stack = [], [], []
    for t, opening, _, n in sorted(marks):
        if opening:
            stack.append(n)
        elif n in stack:
            del stack[len(stack) - 1 - stack[::-1].index(n)]
        times.append(t)
        names.append(stack[-1] if stack else None)

    def at(t):
        k = bisect.bisect_right(times, t) - 1
        return names[k] if k >= 0 else None

    return at


def read(events, t) -> dict:
    """The program's spans among the profiler's `events`, against `t`, the
    benchmark's `Trace` of the same events."""
    from advmix_tpu_torch.utils.profiling import PREFIX, phase_rows

    from portbench import trace as tr

    t0 = time.perf_counter()
    host_names = frozenset(e.name() for e in events if tr._on_host(e))
    a, b = t.window
    spans, launch_at, host_ops, device = [], {}, {}, []
    for e in events:
        name = e.name()
        if tr._on_host(e) and name.startswith(PREFIX):
            if a <= e.start_ns() < b:
                spans.append((name, e.start_ns(),
                              e.start_ns() + e.duration_ns()))
            continue
        kind = tr._kind(e, host_names)
        if kind in tr._LAUNCH_KINDS:
            launch_at[e.correlation_id()] = e.start_ns()
        elif kind == "cpu_op":
            host_ops[e.correlation_id()] = e.start_ns()
        elif kind in tr._DEVICE_KINDS:
            device.append(e)
    ops = []
    for e in device:
        at = launch_at.get(e.correlation_id())
        if at is None:
            at = host_ops.get(e.linked_correlation_id())
        ops.append((at, e.start_ns(), e.start_ns() + e.duration_ns()))
    rows = phase_rows(spans, ops, t.n_iters, 1e-6)
    by = {r[0]: r for r in rows}
    step_ms = t.device_s_in("pb.step") / t.n_iters * 1e3
    sums = {k: sum(by[p][3] for p in ps if p in by)
            for k, ps in PARTS.items() if any(p in by for p in ps)}

    inner = _innermost(spans)

    def label(s):
        n = inner(s)
        return t.span_at(s) + ("" if n is None else f" > {n}")

    gaps = t.gaps()
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return {"n_iters": t.n_iters, "step_device_ms": step_ms,
            "phase_sums_device_ms": sums,
            "phase_sum_over_step": {k: v / step_ms for k, v in sums.items()
                                    if step_ms},
            "columns": ["span", "calls", "host_ms", "device_ms", "idle_ms",
                        "device_ops"],
            "rows": [list(r) for r in rows],
            "idle_gaps": [[label(s), (e - s) * 1e-9] for s, e in longest],
            "gaps": len(gaps),
            "gaps_in_a_program_span": sum(inner(s) is not None
                                          for s, _ in gaps),
            "read_s": time.perf_counter() - t0}


def reading_reduce(reduce, out: dict):
    """`trace.Profiler.reduce` that also reads the program's spans into
    `out` (`read`), from the same events."""

    def wrapped(self):
        t = reduce(self)
        out.update(read(list(self.prof.profiler.kineto_results.events()), t))
        return t

    return wrapped


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    path = None
    if "--out" in argv:
        k = argv.index("--out")
        path = argv[k + 1]
        del argv[k:k + 2]

    from portbench import run, trace as tr

    got: dict = {}
    tr.Profiler.reduce = reading_reduce(tr.Profiler.reduce, got)
    rc = run.main(argv)
    if got:
        k = argv.index("--workload") if "--workload" in argv else None
        got["workload"] = None if k is None else argv[k + 1]
        line = json.dumps(got)
        print(f"[phases] {line}", file=sys.stderr, flush=True)
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            with open(path, "w") as f:
                f.write(line + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())
