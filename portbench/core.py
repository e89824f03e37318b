"""What every cell shares: finding a cell's files by name, the cell's
context, the measured window, the traced window and the result line.

A cell (`BENCHMARK.json` "workloads") names a configuration and a traffic
mix. The configuration is `portbench/configs/<config>.json`; the traffic mix
is `portbench/traffic/<traffic>.json`, whose "kind" names the module
`portbench/kinds/<kind>.py` that drives the program's entry; the limits of
the output check are `portbench/limits/<cell>.json`; each per-layer metric
is read by `portbench/metrics/<metric>.py`. Nothing else is looked up.
"""

from __future__ import annotations

import importlib
import json
import math
import os
import statistics
import sys
import time
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# the JAX package and JAX itself: none may be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "advmix_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


@dataclass
class Cell:
    """One cell with its files read."""

    name: str
    chips: int
    config: dict  # portbench/configs/<config>.json
    traffic: dict  # portbench/traffic/<traffic>.json
    limits: dict  # portbench/limits/<cell>.json: number -> limit
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list


def find_cell(bench: dict, name: str, base: str = HERE) -> Cell:
    """The cell `name` of `bench` with its files read from `base`
    (`portbench/`)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; have "
                         f"{sorted(cells)}")
    w = cells[name]

    def applies(m):
        return "workloads" not in m or name in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if applies(m) and m["moves"] in reported]
    return Cell(name=name, chips=int(w["chips"]),
                config=load_json(base, "configs", w["config"] + ".json"),
                traffic=load_json(base, "traffic", w["traffic"] + ".json"),
                limits=load_json(base, "limits", name + ".json"),
                end_to_end=e2e, per_layer=per_layer)


def port_config(config: dict):
    """The program's ConfigNode of a configuration file: the defaults, then
    the file's "yaml" block (the repository YAML as it is run)."""
    from advmix_tpu_torch.config import get_default_config

    cfg = get_default_config()
    cfg.merge_from_dict(config["yaml"])
    cfg.freeze()
    return cfg


@dataclass
class Context:
    """What a kind's cell gets: the configuration and traffic files, the
    program's config, the seed and the device. `float64` (a witness of the
    output check, never a cell) runs both sides' models in float64."""

    cell: Cell
    cfg: object
    seed: int
    device: object
    float64: bool = False


def kind_module(traffic: dict):
    return importlib.import_module(f"portbench.kinds.{traffic['kind']}")


def metric_reader(name: str):
    return importlib.import_module(f"portbench.metrics.{name}")


def percentile(values, q: int) -> float:
    """The q-th percentile (statistics.quantiles, inclusive method); the
    value itself where there is one."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def process_start() -> float:
    """The wall-clock time at which this process started (Linux /proc);
    the time of this call where that is unreadable."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def measure(cell_obj, seconds: float, profiler=None):
    """Iterations back to back until `seconds` have passed; each ends
    synchronised with the device. Returns the seconds of each iteration and
    the window's length. With a profiler, the iterations it covers run
    inside `pb.iter` spans and are left out of `times`."""
    times, traced = [], []
    i = 0
    start = time.perf_counter()
    end = start
    while True:
        on = profiler is not None and profiler.traced(i)
        t0 = time.perf_counter()
        if on:
            import torch

            with torch.profiler.record_function("pb.iter"):
                cell_obj.iteration(i, True)
        else:
            cell_obj.iteration(i, False)
        end = time.perf_counter()
        (traced if on else times).append(end - t0)
        if profiler is not None:
            profiler.step()
        i += 1
        if end - start >= seconds and (profiler is None
                                       or i > profiler.last):
            break
    return times, traced, end - start


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)
