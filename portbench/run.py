"""Run one cell of the port's benchmark on this machine's CUDA device.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (weights and inputs from the seed, the program built, every shape
the cell uses warmed up, the first steps read for the output check), then
the measured window of `--seconds`, then the output check against the plain
reference in `portbench/reference/`. The last line of standard output is
one JSON object: `correct`, `attempted`, `failed`, `metrics` and `device`
(and `breakdown` with `--trace 1`), with the numbers compared and their
limits under `checks`, last. `--trace 0` reports the cell's end-to-end
metrics; `--trace 1` profiles a few iterations of the window and reports
its per-layer metrics. Without a CUDA device, or with fewer than the cell
asks for, it exits with code 3 and prints no result.
"""

from __future__ import annotations

import os
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
# every build and kernel cache of the program at a fixed place inside the
# checkout (the decode kernel builds into advmix_tpu_torch/_build/ itself)
_CACHE = os.path.join(_ROOT, ".portbench_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(_CACHE, "inductor")
os.environ.pop("ADVMIX_FROST_DIR", None)  # frost's procedural texture
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402


def _fail(msg: str, code: int) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from portbench import core

    start = core.process_start()
    bench = core.benchmark()
    cell = core.find_cell(bench, args.workload)

    import torch

    if not torch.cuda.is_available():
        _fail("no CUDA device: the benchmark measures the card only", 3)
    if torch.cuda.device_count() < cell.chips:
        _fail(f"{args.workload} needs {cell.chips} devices, "
              f"{torch.cuda.device_count()} present", 3)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), start)
    found = core.forbidden_modules()
    if found:
        _fail(f"modules of JAX or the JAX package were loaded: {found}", 4)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             start: float) -> dict:
    """Set up, measure and check one cell; the result line as a dict."""
    import torch

    from portbench import core, trace as tr

    cfg = core.port_config(cell.config)
    torch.backends.cudnn.benchmark = bool(cfg.CUDNN.BENCHMARK)
    ctx = core.Context(cell=cell, cfg=cfg, seed=seed, device=device)
    kind = core.kind_module(cell.traffic)
    work = kind.CellRun(ctx)
    work.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.time() - start

    profiler = None
    if trace:
        t = cell.traffic.get("trace", {})
        profiler = tr.Profiler(int(t.get("skip", 3)), int(t.get("active", 4)))
        with profiler:
            times, traced, window = core.measure(work, seconds, profiler)
    else:
        times, traced, window = core.measure(work, seconds)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    attempted = len(times) + len(traced)
    if len(times) >= 4:
        q = [x * 1e3 for x in statistics.quantiles(times, n=4)]
        print(f"[portbench] {len(times)} timed iterations in {window:.3f} s;"
              f" quartiles {q[0]:.3f} / {q[1]:.3f} / {q[2]:.3f} ms; "
              f"set-up {setup_s:.3f} s", file=sys.stderr, flush=True)

    metrics = {}
    result = {"correct": False, "attempted": attempted, "failed": 0}
    if trace:
        t = profiler.reduce()
        t.iter_s = times
        t.extra = work.trace_extra()
        t.flops_per_iter = work.flops_per_iter()
        for m in cell.per_layer:
            v = core.metric_reader(m["name"]).read(t)
            if v is not None and core.finite(v):
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        busy = t.busy_s()
        breakdown = t.breakdown()
    else:
        values = work.end_to_end(times, window)
        values["setup_s"] = setup_s
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}

    work.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = work.check()
    checks = {k: {"value": numbers[k], "limit": cell.limits[k]}
              for k in cell.limits}
    correct = all(core.finite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    result.update(correct=correct, metrics=metrics)
    result["device"] = device_info(device, peak)
    if trace:
        result["device"].update(busy_s=busy, window_s=t.window_s)
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def device_info(device, peak: int) -> dict:
    import subprocess

    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(peak)}
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", str(device.index or 0)], capture_output=True, text=True,
            timeout=20).stdout.strip()
        info["power_limit"] = limit
    except (OSError, subprocess.SubprocessError):
        info["power_limit"] = "not read"
    return info


if __name__ == "__main__":
    sys.exit(main())
