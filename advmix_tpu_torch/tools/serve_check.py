"""Time a served program's `PoseServer.predict` on the card, and probe
whether the server's cuDNN plans answer one input twice with the same bits.

    python -m advmix_tpu_torch.tools.serve_check --export_dir <dir> \
        [--benchmark 1] [--probe 32]

It sets the process's `cudnn.benchmark` (the YAMLs' CUDNN.BENCHMARK is on,
and `tools/export.py` applies it to its process; the serve CLI leaves it
off) and leaves `cudnn.deterministic` at PyTorch's default, off. Then it
loads the program, predicts 20 times at batch 128 (a fixed-batch
program's own size when it is smaller) on seeded images after 3 warm-ups,
host copies included, and checks that every answer has the first's bits.

The probe (--probe N > 0) runs PoseResNet-18 64x64's three transposed
convolutions on seeded inputs at batch sizes 1..N, twice each: first in a
fresh thread, then through `PoseServer.call`, both with autotuning on and
nondeterministic plans allowed in the process. Autotuning can pick a plan
that sums with atomics, whose two answers then differ; the server's calls
allow only deterministic plans. The probe reports, for each, the batch
sizes whose two answers differ.

It prints the card's name and power limit, then one JSON line. It raises
without a card: a CPU time is not a measurement of the port. The package
it reads is the one on its path, so it times any checkout's server from
that checkout's root: two checkouts in turns compare their servers.
"""

from __future__ import annotations

import argparse
import json
import statistics
import threading
import time

import numpy as np
import torch

from ..utils.device import resolve_device
from .bench import card_line
from .serve import PoseServer

# PoseResNet-18 64x64 (experiments/synthetic/res18_64x64_smoke.yaml): the
# deconv head's input channels and size, and its filters (kernel 4, stride 2)
PROBE_HEAD = (512, 2, 2, (64, 64, 64))
BATCH, ITERS = 128, 20


def deconv_head(device, seed: int = 0) -> torch.nn.Module:
    """The three transposed convolutions of PoseResNet-18 64x64, seeded."""
    cin, _, _, filters = PROBE_HEAD
    layers = []
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        for cout in filters:
            layers += [torch.nn.ConvTranspose2d(cin, cout, 4, 2, 1,
                                                bias=False),
                       torch.nn.ReLU()]
            cin = cout
    return torch.nn.Sequential(*layers).to(device).eval()


@torch.no_grad()
def repeats_differ(head, batches, device) -> list:
    """The batch sizes at which two calls of `head` on one input differ."""
    cin, h, w, _ = PROBE_HEAD
    out = []
    for b in batches:
        x = torch.randn(b, cin, h, w,
                        generator=torch.Generator().manual_seed(b))
        x = x.to(device)
        if not torch.equal(head(x), head(x)):
            out.append(b)
    return out


def repeat_probe(server: PoseServer, n: int) -> dict:
    """{"thread": [...], "server": [...]}: the batch sizes 1..n whose two
    answers differ, in a fresh thread and through `server.call`, with the
    process's cuDNN flags set to autotune and allow nondeterministic plans
    (and put back after)."""
    cudnn = torch.backends.cudnn
    before = cudnn.benchmark, cudnn.deterministic
    cudnn.benchmark, cudnn.deterministic = True, False
    try:
        head = deconv_head(server.device)
        batches = range(1, n + 1)
        got = {}
        # a thread of its own: PyTorch keeps cuDNN's plans per thread
        t = threading.Thread(target=lambda: got.update(
            thread=repeats_differ(head, batches, server.device)))
        t.start()
        t.join()
        got["server"] = server.call(repeats_differ, head, batches,
                                    server.device)
        return got
    finally:
        cudnn.benchmark, cudnn.deterministic = before


def time_predict(server: PoseServer, batch: int, iters: int,
                 seed: int = 0) -> dict:
    """Wall ms of each of `iters` predicts at `batch` after 3 warm-ups, and
    whether every answer has the first's bits."""
    h, w = server.image_hw
    x = np.random.RandomState(seed).randn(batch, h, w, 3).astype(np.float32)
    first = server.predict(x)
    for _ in range(2):
        server.predict(x)
    ms, same = [], True
    for _ in range(iters):
        t0 = time.perf_counter()
        got = server.predict(x)
        ms.append((time.perf_counter() - t0) * 1e3)
        same = same and np.array_equal(got, first, equal_nan=True)
    return {"ms": ms, "best_ms": min(ms), "median_ms": statistics.median(ms),
            "img_s": batch / min(ms) * 1e3, "same": same}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--export_dir", required=True)
    ap.add_argument("--benchmark", type=int, default=1,
                    help="the process's cudnn.benchmark (1: on)")
    ap.add_argument("--probe", type=int, default=32,
                    help="probe batch sizes 1..N (0: no probe)")
    args = ap.parse_args(argv)
    device = resolve_device(None)  # raises without a card
    torch.backends.cudnn.benchmark = bool(args.benchmark)
    t0 = time.perf_counter()
    server = PoseServer(args.export_dir, str(device))
    load_s = time.perf_counter() - t0
    batch = min(BATCH, server.batch or BATCH)
    out = {"export_dir": args.export_dir,
           "program_batch": server.batch or "polymorphic", "batch": batch,
           "benchmark": bool(args.benchmark), "load_s": load_s,
           **time_predict(server, batch, ITERS)}
    if args.probe:
        out["probe_differ"] = repeat_probe(server, args.probe)
    server.close()
    print(card_line())
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
