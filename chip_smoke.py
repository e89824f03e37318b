#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
1. card: require CUDA, print the card's name and power limit, turn TF32
   off for the f32 comparisons;
2. build: compile the port's CUDA kernels (advmix_tpu_torch/csrc) with
   nvcc for sm_90a and print the build time;
3. kernels: time an empty kernel (the launch floor) and the card's expf
   rate; hold each kernel against its plain PyTorch version on the card
   (decode bit-equal on both routes; OKS within rtol 1e-5, atol 1e-6 and
   symmetric to the bit; NMS keep lists equal to the numpy oracle); time
   kernel, plain version and the first designs kept for comparison in
   turns with CUDA events, decode at the eval batch and OKS at this run's
   shapes and at those of a COCO val2017 pass (M=1600 P=32 on ground-truth
   boxes, M=4096 P=128 on the detector's); time the whole batched OKS
   route of COCO eval once;
4. full path: experiments/coco/hrnet/w32_256x192_advmix.yaml at full
   width (seeded random weights, bf16, flip test, batch 128) through the
   port's validate() on a synthetic COCO val set, counting the kernels'
   launches on that run, and read the decode kernel's time inside the
   eval step from the profiler;
5. print a `kernels` JSON line and, last, the device JSON line.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from statistics import fmean as mean

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
CFG = os.path.join(HERE, "experiments/coco/hrnet/w32_256x192_advmix.yaml")
# published H100 SXM peaks (NVIDIA H100 datasheet): HBM bytes/s and
# f32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
SEED = 0


def log(*a):
    print(*a, flush=True)


class Flush:
    """Empties the 50 MB L2 cache between timed calls. "read" streams the
    128 MB buffer through it, which leaves clean lines, as a caller finds
    the cache when its input was written long ago. "write" overwrites 64 MB
    of it, which leaves the cache full of dirty lines: the next kernel's
    loads then wait on their write-back, so it reads slower than the bytes
    it moves itself would make it."""

    def __init__(self, buf: torch.Tensor, by: str = "read"):
        self.buf, self.by = buf, by

    def __call__(self) -> None:
        if self.by == "read":
            self.buf.view(torch.int32).max()
        else:
            self.buf[:64 << 20].zero_()


def time_ms(fn, iters: int = 20, flush: Flush | None = None) -> float:
    """Mean device ms of one fn() call, by CUDA events around `iters` calls
    after 3 warm-ups. A sleep kernel holds the stream while the host
    enqueues the calls, so Python's launch overhead is not timed. With
    `flush`, the L2 cache is emptied before each call and the flushes' own
    time, measured alone, is subtracted."""
    if flush is not None:
        flush()  # its first call loads its kernel
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    host_s = (time.perf_counter() - t0) / 3

    def run(call: bool) -> float:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        # ~2e9 cycles/s: sleep 1.5x the host's enqueue time of the loop
        torch.cuda._sleep(int(3e9 * (host_s + 1e-4) * iters))
        start.record()
        for _ in range(iters):
            if flush is not None:
                flush()
            if call:
                fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    total = run(True)
    if flush is not None:
        total -= run(False)
    return total / iters


def wall_ms(fn, iters: int = 10) -> float:
    """Mean ms of fn() by CUDA events around back-to-back calls after 3
    warm-ups, host launch overhead included (what a caller waits)."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profiled(fn, steps: int = 3):
    """Run fn() `steps` times under torch.profiler after one warm-up.
    Returns (wall us of the window, {kernel name: (device us, launches)})."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    return wall_us, by_name


def profile_step(fn, steps: int = 3) -> float:
    """Device time of `steps` calls by kernel family (torch.profiler),
    and the device's busy share of the window's wall time. Returns the mean
    ms per launch of the decode kernel where the step runs it (after the
    loss and the PCK sums have read the heatmaps)."""
    wall_us, by_name = profiled(fn, steps)
    busy_us = sum(t for t, _ in by_name.values())
    n_kernels = sum(n for _, n in by_name.values())
    log(f"[profile] {steps} eval steps: wall {wall_us / 1e3:.3f} ms, device "
        f"busy {busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}%), "
        f"{n_kernels // steps} kernels per step")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"[profile]   {t / steps / 1e3:8.3f} ms/step  {n // steps:5d} "
            f"launches/step  {name[:90]}")
    seen = [tn for name, tn in by_name.items() if "decode_warp_kernel" in name]
    if len(seen) != 1 or seen[0][1] != steps:
        raise AssertionError("the decode kernel did not run once per step")
    in_step = seen[0][0] / steps / 1e3
    log(f"[profile] decode kernel in its place in the step: {in_step:.5f} ms "
        "per launch (the profiler's kernel time)")
    return in_step


def decode_after_forward(forward, image) -> dict:
    """Both routes of csrc/decode.cu in the cache state the step leaves:
    each is forced in turn (a, b, b, a) on the step's own heatmaps right
    after the two forwards and the flip average that wrote them, and the
    profiler's time of its kernel is read. Returns route -> mean ms per
    launch."""
    from advmix_tpu_torch.ops.cuda.timing import decode_by

    kernel_of = {"scalar": "decode_block_kernel",
                 "vector": "decode_warp_kernel"}
    reads: dict = {r: [] for r in kernel_of}
    for route in ("scalar", "vector", "vector", "scalar"):
        _, by_name = profiled(lambda: decode_by(route, forward(image)))
        seen = [tn for name, tn in by_name.items() if kernel_of[route] in name]
        if len(seen) != 1:
            raise AssertionError(f"{kernel_of[route]} did not run in the step")
        reads[route].append(seen[0][0] / seen[0][1] / 1e3)
    for route, pair in reads.items():
        log(f"[profile] decode right after the step's forward, {route} route: "
            f"{pair[0]:.5f} / {pair[1]:.5f} ms in turns, mean "
            f"{mean(pair):.5f} ms per launch (the profiler's kernel time, "
            "3 steps each)")
    return {r: mean(pair) for r, pair in reads.items()}


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_F32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3 inputs
# ---------------------------------------------------------------------------

def decode_inputs(rng, b=128, j=17, h=64, w=48) -> np.ndarray:
    """Random maps plus crafted ones: exact ties (one in a later row and
    an earlier column), bf16-quantized maps, an all-zero map, negative
    maps and peaks on and next to every border."""
    hm = rng.randn(b, j, h, w).astype(np.float32)
    hm[0, 0] = 0.0
    hm[0, 1] = -np.abs(hm[0, 1]) - 1.0
    hm[0, 2] = np.round(rng.rand(h, w) * 4) / 4  # many exact ties
    hm[0, 3] = rng.rand(h, w) * 0.5
    hm[0, 3, 5, 40] = 2.0
    hm[0, 3, 30, 3] = 2.0  # later row, earlier column: loses the tie
    hm[0, 4] = -np.inf
    hm[1] = torch.from_numpy(hm[1]).to(torch.bfloat16).float().numpy()
    c = 0
    for py in (0, 1, h - 2, h - 1):
        for px in (0, 1, w - 2, w - 1):
            m = hm[2 + c // j, c % j]
            m[:] = rng.rand(h, w)
            m[py, px] = 5.0
            c += 1
    return hm


def oks_inputs(rng, m: int, p: int, j: int = 17):
    """M images of P candidates scattered around one pose each."""
    base = rng.uniform(50, 400, (m, 1, j, 2))
    kpts = base + rng.randn(m, p, j, 2) * rng.uniform(1, 30, (m, p, 1, 1))
    scores = rng.uniform(0.1, 1.0, (m, p))
    areas = rng.uniform(1000, 9000, (m, p))
    return kpts.astype(np.float32), scores, areas


def flat_kpts(kpts: np.ndarray) -> np.ndarray:
    """(P, J, 2) -> (P, 3J) with unit visibility, as oks_nms_np takes."""
    p, j, _ = kpts.shape
    out = np.ones((p, j, 3))
    out[:, :, :2] = kpts
    return out.reshape(p, -1)


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version, and the timings
# ---------------------------------------------------------------------------

def in_turns(fns: dict, flush=None, iters: int = 20) -> dict:
    """Time every fn of `fns` in order and then in reverse order (a, b, c,
    c, b, a), so that a drift of the card's clocks falls on all alike.
    Returns name -> (first reading, second reading) in ms."""
    first = {k: time_ms(f, iters, flush) for k, f in fns.items()}
    second = {k: time_ms(fns[k], iters, flush) for k in reversed(fns)}
    return {k: (first[k], second[k]) for k in fns}


def yardsticks(dev, flush) -> None:
    """The launch floor (an empty kernel timed as the kernels are) and the
    card's expf rate, printed for PERF.md; neither enters a bound."""
    from advmix_tpu_torch.ops.cuda.timing import empty_launch, expf_probe

    warm = time_ms(lambda: empty_launch(dev))
    cold = time_ms(lambda: empty_launch(dev), flush=flush)
    log(f"[kernels] launch floor: {warm:.5f} ms (an empty kernel under "
        f"time_ms; {cold:.5f} ms with the L2 flush subtracted)")
    blocks, threads, iters = 132 * 8, 256, 1024
    out = torch.empty(blocks * threads, device=dev)
    n = expf_probe(out, blocks, threads, iters)
    ms = time_ms(lambda: expf_probe(out, blocks, threads, iters))
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise AssertionError("expf probe wrote a value that is not finite")
    log(f"[kernels] expf rate: {n / ms / 1e6:.1f} G expf/s ({n} expf and "
        f"as many adds in {ms:.4f} ms)")


def decode_phase(dev, rng, flush) -> dict:
    from advmix_tpu_torch.ops.cuda.decode_kernel import (
        decode_heatmaps, decode_heatmaps_plain, decode_route)
    from advmix_tpu_torch.ops.cuda.timing import decode_by

    designs = ("scalar", "vector")  # the first design; the redesign
    hm = torch.from_numpy(decode_inputs(rng)).to(dev)
    b, j, h, w = hm.shape
    # the same maps as a contiguous view that is only 4-byte aligned
    shifted = torch.empty(hm.numel() + 1, device=dev)[1:].view_as(hm)
    shifted.copy_(hm)
    if decode_route(h, w, hm.data_ptr()) != "vector" or decode_route(
            h, w, shifted.data_ptr()) != "scalar":
        raise AssertionError("decode_route: aligned maps must take the "
                             "vector route, the shifted view the scalar one")
    err = 0.0
    for post in (True, False):
        cp, mp = decode_heatmaps_plain(hm, post_process=post)
        fin = torch.isfinite(mp)  # -inf maps: inf - inf is NaN
        few = hm[:3, :5].contiguous()  # 15 maps: not whole blocks of 4
        runs = {"wrapper": (decode_heatmaps(hm, post), (cp, mp)),
                "wrapper, shifted view": (decode_heatmaps(shifted, post),
                                          (cp, mp)),
                "wrapper, 15 maps": (decode_heatmaps(few, post),
                                     (cp[:3, :5], mp[:3, :5]))}
        runs.update({d: (decode_by(d, hm, post), (cp, mp)) for d in designs})
        torch.cuda.synchronize()
        for name, (got, want) in runs.items():
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                bad = (got[0] != want[0]).any(-1).nonzero()[:5].tolist()
                raise AssertionError(f"decode {name} (post={post}) differs "
                                     f"from the plain version at maps {bad}")
        ck, mk = runs["wrapper"][0]
        err = max(err, float((ck - cp).abs().max()),
                  float((mk - mp)[fin].abs().max()))
    log(f"[kernels] decode {tuple(hm.shape)}: the wrapper (vector route; "
        "scalar route on a 4-byte aligned view) and the routes "
        f"{', '.join(designs)} forced are bit-equal to the plain version "
        "(random, ties, bf16, zero, negative, -inf, border peaks)")

    hm_main = torch.randn(b, j, h, w, device=dev)
    nb, by = bound(b * j * h * w * 4 + b * j * 3 * 4, b * j * h * w)
    fns = {d: (lambda d=d: decode_by(d, hm_main)) for d in designs}
    fns["wrapper"] = lambda: decode_heatmaps(hm_main)
    fns["plain"] = lambda: decode_heatmaps_plain(hm_main)
    times = {}
    # three cache states: the L2 emptied by reads (clean lines: the bound's
    # own premise, and the reading that goes into the report), emptied by
    # writes (dirty lines: what a write flush costs the kernel after it),
    # and left warm (the 26.7 MB batch fits in the 50 MB cache)
    states = {"cold L2": flush,
              "cold L2 left dirty": Flush(flush.buf, "write"),
              "warm L2": None}
    for state, fl in states.items():
        for name, pair in in_turns(fns, fl).items():
            log(f"[kernels] decode {tuple(hm.shape)} {state}, {name}: "
                f"{pair[0]:.5f} / {pair[1]:.5f} ms in turns, mean "
                f"{mean(pair):.5f} ms = {100 * nb / mean(pair):.1f}% of the "
                f"bound {nb:.5f} ms ({by})")
            times[state, name] = mean(pair)
    return dict(
        name="decode_heatmaps", route="cuda",
        source="advmix_tpu_torch/csrc/decode.cu",
        replaces="advmix_tpu/ops/pallas/decode_kernel.py:73",
        shape=f"{tuple(hm.shape)} f32, the eval batch, cold L2",
        max_abs_err=err, ms=times["cold L2", "wrapper"],
        plain_ms=times["cold L2", "plain"], bound_ms=nb, bound_by=by,
        library_ms=None,
        # the same kernel in the other two cache states, and the first
        # design (block per map) in the reported one
        ms_dirty_l2=times["cold L2 left dirty", "wrapper"],
        ms_warm_l2=times["warm L2", "wrapper"],
        first_design_ms=times["cold L2", "scalar"])


def oks_bounds(m: int, p: int, j: int = 17):
    """(bound for all P x P entries, bound for the P(P+1)/2 entries the
    symmetric matrix needs), each (ms, "bytes" or "operations"). Every
    output byte is written either way."""
    nbytes = m * p * j * 2 * 4 + m * p * 4 + j * 4 + m * p * p * 4
    per_entry = 9 * j + 4
    return (bound(nbytes, m * p * p * per_entry),
            bound(nbytes, m * p * (p + 1) // 2 * per_entry))


def oks_phase(dev, rng, flush, m_main: int, p_main: int, n_big: int) -> dict:
    from advmix_tpu_torch.native import greedy_from_matrix
    from advmix_tpu_torch.ops.cuda.oks_kernel import (
        oks_matrix, oks_matrix_batched, oks_matrix_batched_plain)
    from advmix_tpu_torch.ops.cuda.timing import oks_baseline, oks_by_micro
    from advmix_tpu_torch.ops.nms import oks_nms_np

    def check(kind, m, p):
        kpts, scores, areas = oks_inputs(rng, m, p)
        kt = torch.from_numpy(kpts).to(dev)
        at = torch.from_numpy(areas.astype(np.float32)).to(dev)
        if kind == "batched":
            got = oks_matrix_batched(kt, at)
        else:
            got = oks_matrix(kt[0], at[0])[None]
        want = oks_matrix_batched_plain(kt, at)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        if not torch.equal(got, got.transpose(1, 2)):
            raise AssertionError(f"oks {kind} M={m} P={p}: the matrix is not "
                                 "symmetric to the bit")
        for micro in (1, 2, 4):
            if not torch.equal(oks_by_micro(kt, at, micro), got):
                raise AssertionError(f"oks M={m} P={p}: micro-tile {micro} "
                                     "differs from the wrapper's result")
        torch.testing.assert_close(oks_baseline(kt, at), want, rtol=1e-5,
                                   atol=1e-6)
        e = float((got - want).abs().max())
        sims = got[:4].cpu().numpy()
        for i in range(min(m, 4)):
            keep = greedy_from_matrix(sims[i], scores[i].astype(np.float32),
                                      0.9)
            ref = oks_nms_np(flat_kpts(kpts[i].astype(np.float64)),
                             scores[i], areas[i], 0.9)
            if keep != ref:
                raise AssertionError(f"oks {kind} M={m} P={p} image {i}: "
                                     f"keep {keep} != oks_nms_np {ref}")
        log(f"[kernels] oks {kind} M={m} P={p}: max |err| {e:.3g}, symmetric "
            "to the bit, micro-tiles 1/2/4 identical, keep lists equal "
            "oks_nms_np")
        return e, kt, at

    def timed(label, kt, at, wrapper_fn, cold):
        m, p = kt.shape[:2]
        (full, full_by), (need, need_by) = oks_bounds(m, p)
        fns = {"baseline": lambda: oks_baseline(kt, at)}
        fns.update({f"micro {k}": (lambda k=k: oks_by_micro(kt, at, k))
                    for k in (1, 2, 4)})
        fns["wrapper"] = wrapper_fn
        fns["plain"] = lambda: oks_matrix_batched_plain(kt, at)
        times = in_turns(fns, flush if cold else None)
        for name, pair in times.items():
            log(f"[kernels] oks {label}{' cold L2' if cold else ''}, {name}: "
                f"{pair[0]:.5f} / {pair[1]:.5f} ms in turns, mean "
                f"{mean(pair):.5f} ms = {100 * full / mean(pair):.2f}% of "
                f"the bound for P x P entries {full:.6f} ms ({full_by}), "
                f"{100 * need / mean(pair):.2f}% of the bound for "
                f"P(P+1)/2 entries {need:.6f} ms ({need_by})")
        # the report takes the bound of the entries the function needs
        return times, need, need_by

    errs = {"batched": 0.0, "single": 0.0}
    for p in (2, 15, 16, 17, 33, 128):
        errs["batched"] = max(errs["batched"], check("batched", 64, p)[0])
    e, kb, ab = check("batched", m_main, p_main)
    errs["batched"] = max(errs["batched"], e)
    for n in (300, n_big):
        e, ks, as_ = check("single", 1, n)
        errs["single"] = max(errs["single"], e)

    report = {}
    times, nb, by = timed(f"M={m_main} P={p_main}", kb, ab,
                          lambda: oks_matrix_batched(kb, ab), cold=False)
    report["oks_matrix_batched"] = dict(
        name="oks_matrix_batched", route="cuda",
        source="advmix_tpu_torch/csrc/oks.cu",
        replaces="advmix_tpu/ops/pallas/oks_kernel.py:68",
        shape=f"M={m_main} P={p_main} J=17, this run's validate() pass",
        max_abs_err=errs["batched"], ms=mean(times["wrapper"]),
        plain_ms=mean(times["plain"]), bound_ms=nb, bound_by=by,
        library_ms=None)
    times, nb, by = timed(f"N={n_big}", ks, as_,
                          lambda: oks_matrix(ks[0], as_[0]), cold=False)
    report["oks_matrix"] = dict(
        name="oks_matrix", route="cuda",
        source="advmix_tpu_torch/csrc/oks.cu",
        replaces="advmix_tpu/ops/pallas/oks_kernel.py:115",
        shape=f"N={n_big} J=17, this run's validate() pass",
        max_abs_err=errs["single"], ms=mean(times["wrapper"]),
        plain_ms=mean(times["plain"]), bound_ms=nb, bound_by=by,
        library_ms=None)

    # the shapes of one COCO val2017 pass: ground-truth boxes (6,352
    # people; this YAML) and the detector's boxes (104,125; USE_GT_BBOX
    # false), both checked and timed with a cold L2
    for m, p in ((1600, 32), (4096, 64), (4096, 128)):
        e, kt, at = check("batched", m, p)
        report["oks_matrix_batched"]["max_abs_err"] = max(
            report["oks_matrix_batched"]["max_abs_err"], e)
        timed(f"M={m} P={p}", kt, at, lambda: oks_matrix_batched(kt, at),
              cold=True)
        del kt, at
    return report


def oks_route_timing(dev, rng, m: int = 4096, big: int = 100) -> None:
    """The whole batched OKS route of COCO eval on detected boxes, as
    coco_eval runs it: the padding loop on the host, the copy to the
    device, the kernel, the copy of the (M, 128, 128) matrices back."""
    from advmix_tpu_torch.evaluation.coco_eval import _oks_matrices_batched

    # 2..40 candidates per image (mean 21, as 104,125 boxes over COCO
    # val2017's ~5,000 images), one image of `big` so that P = 128
    counts = rng.randint(2, 41, m)
    counts[0] = big
    cand = []
    for i, n in enumerate(counts):
        kpts, _, areas = oks_inputs(rng, 1, int(n))
        vis = np.ones((n, 17, 1), np.float32)
        cand.append((i, [dict(keypoints=np.concatenate([kpts[0, k], vis[k]],
                                                       1),
                              area=float(areas[0, k])) for k in range(n)]))
    _oks_matrices_batched(cand[:64], 17, dev)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sims = _oks_matrices_batched(cand, 17, dev)
    total = time.perf_counter() - t0
    p = 128
    host = torch.empty(m, p, 17, 2)
    t0 = time.perf_counter()
    on_dev = host.to(dev)
    torch.cuda.synchronize()
    h2d = time.perf_counter() - t0
    out = torch.empty(m, p, p, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out.cpu()
    d2h = time.perf_counter() - t0
    del on_dev, out
    if len(sims) != m or sims[0].shape != (big, big):
        raise AssertionError("batched OKS route returned the wrong matrices")
    log(f"[path] _oks_matrices_batched M={m} P={p} ({int(counts.sum())} "
        f"candidates): {total * 1e3:.1f} ms in all; alone, the copy of the "
        f"keypoints to the device {h2d * 1e3:.1f} ms and of the "
        f"{m * p * p * 4 / 1e6:.0f} MB of matrices back {d2h * 1e3:.1f} ms; "
        "the kernel's own time is on the [kernels] line of this shape, the "
        "rest is the host's padding loop and slicing")


# ---------------------------------------------------------------------------
# phase 4: synthetic COCO val set
# ---------------------------------------------------------------------------

def write_coco_val(root: str, rng, n_images: int = 47, big: int = 130):
    """person_keypoints_val2017.json with n_images images of 2..20 people
    and one image of `big` people. Returns the per-image person counts."""
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    counts = [int(c) for c in rng.randint(2, 21, n_images)] + [big]
    images, anns = [], []
    aid = 1
    for i, n in enumerate(counts, start=1):
        images.append(dict(id=i, width=640, height=480,
                           file_name="%012d.jpg" % i))
        for _ in range(n):
            cx, cy = rng.uniform(100, 540), rng.uniform(100, 380)
            xs = cx + rng.uniform(-40, 40, 17)
            ys = cy + rng.uniform(-80, 80, 17)
            kps = np.stack([xs, ys, np.full(17, 2.0)], 1).reshape(-1)
            x0, y0 = xs.min() - 10, ys.min() - 10
            w, h = xs.max() - x0 + 20, ys.max() - y0 + 20
            anns.append(dict(id=aid, image_id=i, category_id=1,
                             keypoints=[float(v) for v in kps],
                             num_keypoints=17, bbox=[x0, y0, w, h],
                             area=float(w * h), iscrowd=0))
            aid += 1
    with open(os.path.join(root, "annotations",
                           "person_keypoints_val2017.json"), "w") as f:
        json.dump(dict(images=images, annotations=anns,
                       categories=[dict(id=1, name="person")]), f)
    return counts


def main() -> None:
    # ---- 1. card ----------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, HERE)
    from advmix_tpu_torch.config import get_default_config
    from advmix_tpu_torch.data import COCODataset, Loader
    from advmix_tpu_torch.engine.steps import make_eval_step
    from advmix_tpu_torch.engine.trainer import (make_eval_preprocessor,
                                                 to_device, validate)
    from advmix_tpu_torch.models import get_pose_net, he_reinit_convs
    from advmix_tpu_torch.models.layers import set_compute_dtype
    from advmix_tpu_torch.native import get_lib
    from advmix_tpu_torch.ops.cuda import build as kbuild
    from advmix_tpu_torch.ops.cuda.decode_kernel import (
        decode_heatmaps, decode_heatmaps_plain)
    from advmix_tpu_torch.ops.cuda.oks_kernel import (oks_matrix,
                                                      oks_matrix_batched)
    from advmix_tpu_torch.ops.transforms import affine_transform, \
        get_affine_transform, transform_preds_batch

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    log(smi)
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("[card] TF32 off for cuDNN convolutions and matmuls (f32 "
        "comparisons are full f32)")
    log("[card] host NMS scans: " + ("C++ (g++)" if get_lib() is not None
                                     else "Python loop (no g++)"))

    # ---- 2. build ---------------------------------------------------------
    res = kbuild.build(force=True)
    log(f"[build] nvcc sm_90a, {len(kbuild._sources())} sources in "
        f"parallel: {res['seconds']:.2f} s")
    for line in res["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[build] {line.strip()}")
    kbuild.library()

    rng = np.random.RandomState(SEED)
    flush = Flush(torch.zeros(128 << 20, dtype=torch.uint8, device=dev))

    # ---- 3. kernels vs plain versions ------------------------------------
    yardsticks(dev, flush)
    report = {"decode_heatmaps": decode_phase(dev, rng, flush)}
    # the full path's shapes (phase 4's data): 47 images of 2..20 people
    # -> M=47 images padded to P=32, and one image of N=130 people
    n_img, n_big = 47, 130
    counts = [int(c) for c in np.random.RandomState(SEED + 1).randint(
        2, 21, n_img)]
    report.update(oks_phase(dev, rng, flush, n_img,
                            1 << (max(counts) - 1).bit_length(), n_big))
    oks_route_timing(dev, np.random.RandomState(SEED + 3))

    # ---- 4. the full path at full width ----------------------------------
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    got_counts = write_coco_val(tmp, np.random.RandomState(SEED + 1),
                                n_img, n_big)
    assert got_counts[:-1] == counts
    cfg = get_default_config()
    cfg.merge_from_file(CFG)
    cfg.DATASET.ROOT = tmp
    cfg.freeze()
    torch.backends.cudnn.benchmark = bool(cfg.CUDNN.BENCHMARK)

    class SyntheticCropCOCO(COCODataset):
        """The COCO val records, with seeded random uint8 crops in place
        of decoded and warped JPEGs (the records have no images)."""

        eval_seconds = 0.0

        def get_sample(self, idx, rng):
            rec = self.records[idx]
            c = np.asarray(rec["center"], np.float32)
            s = np.asarray(rec["scale"], np.float32)
            trans = get_affine_transform(c, s, 0.0, self.image_size)
            joints = np.stack([affine_transform(p, trans)
                               for p in rec["joints_3d"][:, :2]])
            w, h = (int(v) for v in self.image_size)
            return dict(
                image=np.random.RandomState(idx).randint(
                    0, 256, (h, w, 3), dtype=np.uint8),
                joints=joints.astype(np.float32),
                joints_vis=rec["joints_3d_vis"][:, 0].astype(np.float32),
                center=c, scale=s, score=np.float32(rec["score"]),
                image_path=rec["image"])

        def evaluate(self, *args, **kwargs):
            t0 = time.perf_counter()
            out = super().evaluate(*args, **kwargs)
            self.eval_seconds = time.perf_counter() - t0
            return out

    dataset = SyntheticCropCOCO(cfg, is_train=False)
    loader = Loader(dataset, cfg.TEST.BATCH_SIZE_PER_GPU)
    log(f"[path] {os.path.relpath(CFG, HERE)}: {len(dataset)} people in "
        f"{len(got_counts)} images, {len(loader)} batches of "
        f"{cfg.TEST.BATCH_SIZE_PER_GPU}")

    gen = torch.Generator().manual_seed(SEED)
    model = get_pose_net(cfg)
    he_reinit_convs(model, gen)
    # BN running stats from the batch statistics of seeded random images,
    # so every layer's activations, and the heatmaps, are O(1)
    calib = torch.from_numpy(np.random.RandomState(SEED + 2).randint(
        0, 256, (4, 3, 256, 192)).astype(np.float32) / 64.0 - 2.0)
    for mod in model.modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            mod.reset_running_stats()
            mod.momentum = None  # cumulative: one batch sets the stats
    model.train()
    with torch.no_grad():
        model(calib)
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                # a channel nearly dead on the calibration batch would
                # otherwise get a gain of up to 1/sqrt(eps)
                mod.running_var.clamp_(min=1e-2)
    model.eval()
    n_params = sum(p.numel() for p in model.parameters())

    # the model on the card against the same f32 model on the CPU
    x = torch.from_numpy(np.random.RandomState(3).randn(
        2, 3, 256, 192).astype(np.float32))
    with torch.no_grad():
        ref = model(x)
        got = model.to(dev)(x.to(dev)).cpu()
    # f32 on both sides, TF32 off; cuDNN's and the CPU's convolution
    # algorithms round differently, and ~100 layers compound that
    rel = float((got - ref).abs().max() / ref.abs().max())
    if not (torch.isfinite(got).all() and rel < 2e-3):
        raise AssertionError(f"HRNet-W32 on the card vs the CPU: max |diff| "
                             f"/ max |ref| = {rel:.3g} (limit 2e-3)")
    log(f"[path] HRNet-W32 ({n_params} params) f32 on the card matches the "
        f"CPU: max |diff| / max |ref| = {rel:.3g} (limit 2e-3), "
        f"max |ref| {float(ref.abs().max()):.3g}")

    dtype = torch.bfloat16 if cfg.TRAIN.DTYPE == "bfloat16" else torch.float32
    set_compute_dtype(model, dtype)
    eval_step = make_eval_step(model, cfg, dataset.flip_pairs)
    prep = make_eval_preprocessor(cfg, dev)
    out_dir = os.path.join(tmp, "out")

    for fn in (decode_heatmaps, oks_matrix_batched, oks_matrix):
        fn.launches = 0
    t0 = time.perf_counter()
    name_values, ap = validate(cfg, eval_step, prep, dataset, loader,
                               out_dir, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches
                for fn in (decode_heatmaps, oks_matrix_batched, oks_matrix)}
    log(f"[path] validate(): {wall:.2f} s, launches {launches}")
    if launches["decode_heatmaps"] != len(loader):
        raise AssertionError(f"decode launched {launches['decode_heatmaps']}"
                             f" times for {len(loader)} batches")
    for k in ("oks_matrix_batched", "oks_matrix"):
        if launches[k] < 1:
            raise AssertionError(f"{k} was not launched on the main path")
    if not (np.isfinite(ap) and -1.0 <= ap <= 1.0):
        raise AssertionError(f"AP {ap} is not a valid score")
    res_file = os.path.join(out_dir, "results",
                            "keypoints_val2017_results_0.json")
    with open(res_file) as f:
        results = json.load(f)
    if not results or not all(np.isfinite(r["keypoints"]).all()
                              for r in results):
        raise AssertionError("results json is empty or not finite")

    # one batch again: the step's heatmaps through the kernel and through
    # the plain decode must give identical predictions
    batches = iter(loader)
    host = next(batches)
    batches.close()  # shuts the loader's thread pool down
    batch = prep(to_device(host["image"], dev), to_device(host["joints"], dev),
                 to_device(host["joints_vis"], dev))
    batch.update(center=to_device(host["center"], dev),
                 scale=to_device(host["scale"], dev))
    heat = eval_step.forward(batch["image"])
    if heat.shape != (128, 17, 64, 48) or not torch.isfinite(heat).all():
        raise AssertionError(f"heatmaps {tuple(heat.shape)} not finite")
    ck, mk = decode_heatmaps(heat)
    cp, mp = decode_heatmaps_plain(heat)
    pk = transform_preds_batch(ck, batch["center"], batch["scale"], (48, 64))
    pp = transform_preds_batch(cp, batch["center"], batch["scale"], (48, 64))
    if not (torch.equal(pk, pp) and torch.equal(mk, mp)):
        raise AssertionError("kernel and plain decode preds differ")
    preds, maxvals, _ = eval_step(batch)
    if preds.shape != (128, 17, 2) or not torch.isfinite(preds).all():
        raise AssertionError(f"preds {tuple(preds.shape)} not finite")
    log("[path] one batch: kernel and plain decode give identical preds")

    step_ms = wall_ms(lambda: eval_step(batch))
    log(f"[path] eval step (2x HRNet-W32 bf16 fwd + decode) at batch 128: "
        f"{step_ms:.3f} ms/batch, {128 / step_ms * 1e3:.1f} img/s")
    log(f"[path] COCO eval (rescore + OKS-NMS + AP): "
        f"{dataset.eval_seconds:.3f} s; AP {ap:.4f} (random weights)")
    log(f"[path] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    in_step = profile_step(lambda: eval_step(batch))
    after = decode_after_forward(eval_step.forward, batch["image"])
    report["decode_heatmaps"].update(
        ms_in_step=in_step, ms_after_forward=after["vector"],
        first_design_ms_after_forward=after["scalar"])

    kernels = []
    for k in ("decode_heatmaps", "oks_matrix_batched", "oks_matrix"):
        r = dict(report[k])
        r["launches"] = launches[k]
        kernels.append(r)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
