"""Streaming bandwidth of the card, measured with known traffic.

    python -m advmix_tpu_torch.tools.hbm_peak [--mb 512] [--iters 20] \
        [--device cpu]

Counterpart of `tools/hbm_peak.py`: two passes of known bytes over f32
buffers of `--mb` MiB, each one PyTorch call per launch, `--iters`
launches each: "scale", `torch.mul(x, a, out=y)` (reads x, writes y: 2
buffers of traffic), and "triad", `torch.add(x, z, alpha=a, out=y)` (reads
x and z, writes y: 3). Their time is the profiler's device time of the
launches, summed (on the CPU, with `--device cpu`, the operators' host
time), not the host clock around them. Prints one JSON line: GB/s per
pattern, the larger as `measured_peak_gbs`, and the device's name (on a
card also its power limit, as `nvidia-smi --query-gpu=name,power.limit`
gives it). This is a measuring tool: the roofline of `tools/profile.py`
reads its number.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..utils.device import resolve_device
from .bench import card_line


def device_time_us(prof, device: torch.device, op_name: str) -> float:
    """The launches' time in a profiler window: the card's kernels on a
    card, the named top-level operator's host time on the CPU."""
    from torch.autograd import DeviceType

    if device.type == "cuda":
        return sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.name == op_name and e.cpu_parent is None)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mb", type=int, default=512)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--device", type=str, default=None,
                   help="default: the CUDA device (raises without one)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    from torch.profiler import ProfilerActivity, profile

    n = args.mb * 1024 * 1024 // 4  # f32 elements
    x = torch.full((n,), 1.0, device=device)
    z = torch.full((n,), 0.5, device=device)
    y = torch.empty_like(x)
    patterns = {
        "scale": (lambda: torch.mul(x, 1.0000001, out=y), 2, "aten::mul"),
        "triad": (lambda: torch.add(x, z, alpha=1.0000001, out=y), 3,
                  "aten::add"),
    }
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if device.type == "cuda" else [])
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"=> device: {where}, buffer {args.mb} MiB, {args.iters} launches "
          "per pattern", flush=True)
    results = {}
    for name, (fn, buffers, op) in patterns.items():
        fn()  # the first launch loads the kernel
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        with profile(activities=acts) as prof:
            for _ in range(args.iters):
                fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        us = device_time_us(prof, device, op)
        if us <= 0:
            raise RuntimeError(f"{name}: the profiler recorded no time of "
                               f"the {args.iters} launches")
        gb = buffers * n * 4 * args.iters / 1e9
        results[name] = gb / (us / 1e6)
        print(f"{name:8s} {gb:8.2f} GB in {us / 1e3:8.3f} ms of device time "
              f"-> {results[name]:8.1f} GB/s", flush=True)
    out = {"device": where,
           "card": card_line() if device.type == "cuda" else None,
           "mb": args.mb, "iters": args.iters,
           "measured_peak_gbs": max(results.values()), **results}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
