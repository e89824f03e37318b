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
5. training: experiments/coco/hrnet/w32_256x192_advmix.yaml through the
   port's train entry point (`tools/train.main`, --advmix --sample_times 3:
   HRNet-W32 D and teacher, UNet G, bf16 with f32 master weights, device
   warp) for one epoch of a few iterations of batch 32 on a synthetic COCO
   train set, with the per-epoch validate() (the three kernels launch
   again), a checkpoint, a final state, and a second call that resumes and
   trains nothing; the step's invariants asserted on the card; one f32
   step on the card against the same step on the CPU; the step, the view
   synthesis and both timed at batch 32 and 128 and profiled;
6. corruptions (advmix_tpu_torch/ops/corruptions.py): every deterministic
   form (the 8 key-free types; the exact-render forms of glass, motion,
   snow, elastic and spatter, spatter's water arm only where cv2 imports)
   at severities 1..5 on 4 seeded 256x192 crops, on the card with TF32
   allowed (torch's cuDNN default, and 'high' matmul precision) against the
   CPU, in uint8: at most 1 level and 0.5% of values apart; the traced
   forms of all 19 types on the card: shape, finite, range, two seeds
   differ; each of the 19 types in both forms timed at the sweep's
   (128, 256, 192, 3) with CUDA events, device time and launches per call
   from the profiler;
7. the robustness sweep through its entry point (`tools/test_corruption.main
   --on_the_fly`): HRNet-W32 256x192 at batch 128, clean + the 15
   benchmark types x 5 severities = 76 passes over a synthetic one-batch val
   set of 20 images of 2..8 people, with the phase-4 weights; robust_C.val,
   the CSV, and the decode and batched OKS launches of every pass checked;
8. `tools/train.main --random_corruption` (no AdvMix) for 2 iterations of
   batch 32: losses finite, weights changed;
9. the other COCO families: HRNet-W48 and SimpleBaseline ResNet-50/101/152
   256x192 at full width and depth (seeded random weights; on the card
   against the CPU on one image: f64 equal to 1e-9, f32 as far from the
   f64 forward as the CPU's f32 is), each through validate() at batch 128 in
   bf16 on phase 4's val set (decode on every batch, both OKS routes), then
   one batch timed and profiled (busy share, kernels per step, peak memory;
   device time by kernel family for ResNet-152);
10. MPII at full width: experiments/mpii/hrnet/w32_256x256_advmix.yaml
   (HRNet-W32 256x256, 16 joints) through `tools/train.main --advmix
   --sample_times 3 --stylize_image --sp_style 1` with DEBUG.DEBUG and its
   four dumps on, on a synthetic MPII set (annot json, gt_valid.mat, JPEGs)
   and its stylized copy: 3 iterations of batch 32, validate() to PCKh at
   batch 128, the dump files checked; then the 76-pass MPII-C sweep
   `tools/test_corruption.main --on_the_fly` over one batch of 128 (decode
   76 times, OKS never: PCKh has no NMS); the decode kernel at MPII's
   (128, 16, 64, 64) bit-equal to its plain version on both routes, timed
   beside its bound;
11. TEST.SOFT_ARGMAX: the W32 eval through validate() with the decode
   kernel launched 0 times; soft-argmax on the card against the CPU on the
   step's heatmaps and on peaked (128, 16, 64, 64) maps (within 1e-3
   heatmap px), timed beside the decode kernel, and the two eval steps
   timed in turns;
12. bottom-up: experiments/coco/higher_hrnet/w32_512_advmix.yaml
   (HigherHRNet-W32 512x512, bf16) on synthetic COCO sets written here
   (JPEGs with COCO names, 1-6 people, a crowd RLE and a zero-keypoint
   person per image), seeded weights with BN and heads calibrated (random
   heads make ~500 groups per image); `tools/validate.main` at
   TEST.SCALE_FACTOR [1] and [0.5, 1, 2] and the OCHuman YAML through its
   alias (grouping s/image, groups/image, COCO-eval s; the eval step timed
   and profiled); the float64 infer (both scale settings) and the float64
   AdvMix step on the card against the CPU; `tools/train.main --advmix
   --sample_times 3` (3 iterations of batch 12) and a plain epoch of 2;
   the AdvMix iteration timed and profiled at batch 12 and `tools.bench`;
   `tools/test_corruption.main --on_the_fly` with zoom_blur and
   defocus_blur over one batch of 8 (11 passes). The three kernels launch
   0 times on every bottom-up path, and the phase checks that;
13. print a `kernels` JSON line and, last, the device JSON line.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import copy
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
        # device activities only: the optimizer's "Optimizer.step#..." span
        # is an annotation mirrored onto the device's timeline, not a kernel
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and not e.name.startswith("Optimizer."):
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
    counts = [int(c) for c in rng.randint(2, 21, n_images)] + [big]
    return write_coco(root, "val2017", counts, rng)


def write_coco(root: str, image_set: str, counts, rng):
    """person_keypoints_<image_set>.json with one 640x480 image per entry
    of `counts`, holding that many people. Returns `counts`."""
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
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
                           f"person_keypoints_{image_set}.json"), "w") as f:
        json.dump(dict(images=images, annotations=anns,
                       categories=[dict(id=1, name="person")]), f)
    return counts


# ---------------------------------------------------------------------------
# phase 5: AdvMix training through the train entry point
# ---------------------------------------------------------------------------

TRAIN_ITERS = 3
ALPHA, ADV_W = 0.1, 0.7


def family_of(kernel_name: str) -> str:
    """A coarse family for a profiler kernel name."""
    n = kernel_name.lower()
    for key, fam in (("batch_norm", "batch norm"), ("batchnorm", "batch norm"),
                     ("bn_fw", "batch norm"),
                     ("bn_bw", "batch norm"), ("wgrad", "conv wgrad"),
                     ("dgrad", "conv dgrad"), ("gemm", "conv/gemm"),
                     ("conv", "conv/gemm"), ("cutlass", "conv/gemm"),
                     ("xmma", "conv/gemm"), ("copy", "dtype cast / copy"),
                     ("scatter", "scatter/gather"), ("gather", "scatter/gather"),
                     ("multi_tensor", "optimizer (foreach)"),
                     ("upsample", "upsample"), ("reduce", "reduce"),
                     ("elementwise", "elementwise")):
        if key in n:
            return fam
    return "other"


def profile_by_family(fn, steps: int = 2) -> dict:
    """Device busy share and device time by kernel family of `steps` calls
    of fn() (an AdvMix iteration, an eval step), from torch.profiler."""
    wall_us, by_name = profiled(fn, steps)
    busy_us = sum(t for t, _ in by_name.values())
    fams: dict = {}
    for name, (t, n) in by_name.items():
        ft, fn_ = fams.get(family_of(name), (0.0, 0))
        fams[family_of(name)] = (ft + t, fn_ + n)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return dict(
        wall_ms=wall_us / steps / 1e3, busy_ms=busy_us / steps / 1e3,
        busy_share=busy_us / wall_us,
        kernels=sum(n for _, n in by_name.values()) // steps,
        families={k: (t / steps / 1e3, n // steps) for k, (t, n) in
                  sorted(fams.items(), key=lambda kv: -kv[1][0])},
        top=[(name[:80], t / steps / 1e3, n // steps)
             for name, (t, n) in top])


def check_step_on_card(result, cfg, dev, raw_batch) -> None:
    """One more AdvMix iteration on the trained state, watched: the D
    gradients the D step left are still there after the G step, the mixing
    weights sum to 1, and loss_g is -ADV_W times a positive loss of the
    updated D on the saved mix."""
    import copy

    from advmix_tpu_torch.engine.steps import (_loss_fn_for,
                                               make_advmix_step, mix_views)
    from advmix_tpu_torch.engine.trainer import make_preprocessor

    state = result["state"]
    prep = make_preprocessor(cfg, advmix=True, device=dev, device_warp=True)
    batch = prep(raw_batch, torch.Generator().manual_seed(5))
    step = make_advmix_step(state, cfg, alpha=ALPHA, adv_loss_weight=ADV_W)
    left = {}
    hook = state.optimizer_d.register_step_pre_hook(
        lambda *_: left.update({n: p.grad.clone() for n, p in
                                state.model_d.named_parameters()}))
    metrics = step(batch)
    hook.remove()
    if not left or not all(torch.isfinite(g).all() for g in left.values()):
        raise AssertionError("the D step left no finite gradients")
    for n, p in state.model_d.named_parameters():
        if not torch.equal(p.grad, left[n]):
            raise AssertionError(f"the G step changed D's gradient of {n}")
    w = step.last_mix_weights
    if w.dtype != torch.float32 or w.shape[1] != 3 or not torch.allclose(
            w.sum(1), torch.ones_like(w[:, 0]), atol=1e-5):
        raise AssertionError("the mixing weights do not sum to 1 per pixel")
    # train-mode BN normalizes with the batch's statistics, so a copy of
    # the updated D gives the G step's loss again on the same mix
    views = batch["views"]
    mixed = sum(views[:, 3 * k: 3 * k + 3] * w[:, k: k + 1] for k in range(3))
    with torch.no_grad():
        out = copy.deepcopy(state.model_d).train()(mixed)
        loss = float(_loss_fn_for(cfg)(out, batch["target"],
                                       batch["target_weight"]))
    loss_g = float(metrics["loss_g"])
    if not (loss > 0 and abs(loss_g + ADV_W * loss) <= 2e-2 * abs(loss_g)):
        raise AssertionError(f"loss_g {loss_g} is not -{ADV_W} x the loss "
                             f"{loss} of the updated D on the saved mix")
    log(f"[train] watched step: D's {len(left)} gradients are what the D "
        f"step left; mixing weights f32, sum to 1; loss_g {loss_g:.6f} = "
        f"-{ADV_W} x {loss:.6f} (bf16 forward recomputed, limit 2% apart)")


def step_card_vs_cpu(cfg, start_path: str, dev, dtype: torch.dtype,
                     batch_size: int = 4) -> dict:
    """One AdvMix step (SGD, TF32 off) at full width in `dtype` on the card
    and on the CPU, from the same state and the same views. Returns, for D
    and for G, the difference of the parameters after the step over their
    update, in the max norm and in the 2-norm over the whole net (as the
    forward check takes max |diff| over max |ref|: a conv bias in front of
    a norm has a zero gradient, so its own update is rounding noise and no
    yardstick), and both sides' metrics."""
    from advmix_tpu_torch.engine.state import create_advmix_state
    from advmix_tpu_torch.engine.steps import make_advmix_step
    from advmix_tpu_torch.models import (get_generator, get_pose_net,
                                         load_model_file)

    cfg = cfg.clone()
    cfg.defrost()
    cfg.TRAIN.OPTIMIZER = "sgd"  # Adam's first step is lr * sign(grad):
    cfg.TRAIN.LR = 0.01          # it would hide the gradients' sizes
    cfg.TRAIN.DTYPE = "float32"
    cfg.freeze()
    rng = np.random.RandomState(SEED + 7)
    w, h = cfg.MODEL.IMAGE_SIZE
    hw, hh = cfg.MODEL.HEATMAP_SIZE
    batch = dict(
        views=torch.from_numpy(rng.randn(batch_size, 9, h, w)).to(dtype),
        target=torch.from_numpy(rng.rand(batch_size, 17, hh, hw)).to(dtype),
        target_weight=torch.from_numpy(
            (rng.rand(batch_size, 17) > 0.2).astype(np.float64)).to(dtype))
    after = {}
    for key, where in (("cpu", torch.device("cpu")), ("card", dev)):
        model = get_pose_net(cfg)
        load_model_file(model, start_path)
        g = get_generator()
        with torch.no_grad():  # G's N(0, 0.001) init gives ~0 logits
            for p_ in g.parameters():
                p_.mul_(30.0)
        model, g = model.to(dtype), g.to(dtype)
        start = {"d": {k: v.clone() for k, v in model.state_dict().items()},
                 "g": {k: v.clone() for k, v in g.state_dict().items()}}
        state = create_advmix_state(cfg, model, g, where, dtype)
        step = make_advmix_step(state, cfg, alpha=ALPHA,
                                adv_loss_weight=ADV_W)
        metrics = step({k: v.to(where) for k, v in batch.items()})
        after[key] = dict(
            d={k: v.cpu() for k, v in state.model_d.state_dict().items()},
            g={k: v.cpu() for k, v in state.model_g.state_dict().items()},
            m={k: float(v) for k, v in metrics.items()})
        del state, step, model, g
    out = dict(cpu=after["cpu"]["m"], card=after["card"]["m"])
    for net in ("d", "g"):
        moved = diff = moved2 = diff2 = 0.0
        for k, ref in after["cpu"][net].items():
            if ref.is_floating_point() and "running_" not in k:
                upd = (ref - start[net][k]).double()
                err = (after["card"][net][k] - ref).double()
                moved = max(moved, float(upd.abs().max()))
                diff = max(diff, float(err.abs().max()))
                moved2 += float((upd * upd).sum())
                diff2 += float((err * err).sum())
        out[net] = dict(max=diff / moved, l2=(diff2 / moved2) ** 0.5)
    return out


def train_phase(dev, tmp: str, start_path: str, dataset_cls, kernel_fns):
    """Phase 5. Returns the kernels' launch counts on the training path."""
    from advmix_tpu_torch.engine.trainer import to_device
    from advmix_tpu_torch.models import (get_generator, get_pose_net,
                                         load_model_file)
    from advmix_tpu_torch.tools import train as train_tool
    from advmix_tpu_torch.tools.bench import time_advmix_largest_fit

    # 26 images of 4 people: 104 boxes, TRAIN_ITERS batches of 32 (drop_last)
    write_coco(tmp, "train2017", [4] * 26, np.random.RandomState(SEED + 4))
    out_dir = os.path.join(tmp, "train_out")
    argv = ["--cfg", CFG, "--advmix", "--sample_times", "3", "--alpha",
            str(ALPHA), "--adv_loss_weight", str(ADV_W), "--modelDir",
            out_dir, "--logDir", os.path.join(tmp, "train_log"),
            "--load_from_D", start_path, "DATASET.ROOT", tmp,
            "TRAIN.END_EPOCH", "1", "PRINT_FREQ", "1"]

    def build(cfg, is_train, image_set=None):
        return dataset_cls(cfg, is_train, image_set)

    for fn in kernel_fns:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = train_tool.main(argv, build_dataset=build)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernel_fns}
    log(f"[train] tools/train.main --advmix --sample_times 3, 1 epoch of "
        f"{TRAIN_ITERS} iterations of batch 32 + validate(): {wall:.2f} s "
        f"(cuDNN autotuning and first launches included), peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"kernel launches {launches}")
    for k, n in launches.items():
        if n < 1:
            raise AssertionError(f"{k} was not launched on the training path")

    state, history = result["state"], result["history"]
    if len(history) != 1 or len(history[0]) != TRAIN_ITERS:
        raise AssertionError(f"trained {[len(h) for h in history]} iterations")
    for i, m in enumerate(history[0]):
        log(f"[train] iteration {i}: loss_d {m['loss_d']:.6f} loss_g "
            f"{m['loss_g']:.6f} acc {m['acc']:.4f}")
        if not (np.isfinite(m["loss_d"]) and np.isfinite(m["loss_g"])
                and m["loss_d"] > 0 and m["loss_g"] < 0):
            raise AssertionError(f"iteration {i}: losses {m}")
    if not np.isfinite(result["perf"]):
        raise AssertionError(f"validation score {result['perf']}")

    start = torch.load(start_path, map_location="cpu")
    sd_d = {k: v.cpu() for k, v in state.model_d.state_dict().items()}
    g0 = get_generator().state_dict()
    sd_g = {k: v.cpu() for k, v in state.model_g.state_dict().items()}
    for name, sd, ref in (("D", sd_d, start), ("G", sd_g, g0)):
        floats = [k for k, v in sd.items() if v.is_floating_point()]
        if not all(sd[k].dtype == torch.float32 for k in floats):
            raise AssertionError(f"{name} holds parameters that are not f32")
        changed = sum(not torch.equal(sd[k], ref[k]) for k in floats)
        if changed < 0.9 * len(floats):
            raise AssertionError(f"only {changed} of {len(floats)} tensors "
                                 f"of {name} changed")
    tracked = {int(v) - int(start[k]) for k, v in sd_d.items()
               if k.endswith("num_batches_tracked")}
    if tracked != {2 * TRAIN_ITERS}:
        raise AssertionError(f"D's num_batches_tracked rose by {tracked}, "
                             f"expected {2 * TRAIN_ITERS}: two train-mode "
                             "forwards per iteration")
    convs = 0
    for k, v in state.teacher.state_dict().items():
        want = start[k]
        if v.dtype == torch.bfloat16:
            want = want.to(torch.bfloat16)
            convs += 1
        if not torch.equal(v.cpu(), want):
            raise AssertionError(f"the teacher's {k} moved")
    if state.teacher.training or convs == 0:
        raise AssertionError("the teacher is not a frozen bf16 eval model")
    log(f"[train] D and G changed and are f32; the teacher ({convs} bf16 "
        "conv tensors, f32 BN) is bit-equal to its start; D's BN layers "
        f"counted {2 * TRAIN_ITERS} batches")

    cfg = result["cfg"]
    final = get_pose_net(cfg)
    load_model_file(final, result["final_state"])
    for k, v in final.state_dict().items():
        if not torch.equal(v, sd_d[k]):
            raise AssertionError(f"final_state differs from D at {k}")
    for name in ("checkpoint.pth", "model_best.pth"):
        if not os.path.isfile(os.path.join(result["output_dir"], name)):
            raise AssertionError(f"{name} was not written")

    t0 = time.perf_counter()
    again = train_tool.main(argv, build_dataset=build)
    if again["begin_epoch"] != 1 or again["history"]:
        raise AssertionError("the second call did not resume at epoch 1")
    for k, v in again["state"].model_d.state_dict().items():
        if not torch.equal(v.cpu(), sd_d[k]):
            raise AssertionError(f"the resumed D differs at {k}")
    for k, v in again["state"].model_g.state_dict().items():
        if not torch.equal(v.cpu(), sd_g[k]):
            raise AssertionError(f"the resumed G differs at {k}")
    if again["state"].step != TRAIN_ITERS:
        raise AssertionError("the resumed step count is wrong")
    log(f"[train] second call: AUTO_RESUME at epoch 1, nothing trained, D, "
        f"G and the step count restored ({time.perf_counter() - t0:.2f} s)")
    del again

    # one more iteration on the trained state, watched
    ds = dataset_cls(cfg, True, None)
    samples = [ds.get_raw_sample(i, np.random.RandomState(i),
                                 tuple(cfg.DATASET.WARP_BUCKET))
               for i in range(32)]
    raw = {k: to_device(np.stack([s[k] for s in samples]), dev)
           for k in ("image", "warp_matrix", "joints", "joints_vis")}
    check_step_on_card(result, cfg, dev, raw)
    del result, state, raw
    torch.cuda.empty_cache()

    # float64 shows that the card runs the same step as the CPU (it agrees
    # to 1e-12). f32 is what training computes, and its gradients are
    # chaotic through ~100 train-mode BatchNorms, most of all near the
    # input, where G's whole gradient comes from: with the f64 step equal,
    # an f32 G update half its own size apart is rounding, so its limit
    # only catches a wrong sign or scale
    limits = {torch.float64: dict(d=1e-6, g=1e-6),
              torch.float32: dict(d=5e-2, g=1.0)}
    for dtype, lim in limits.items():
        r = step_card_vs_cpu(cfg, start_path, dev, dtype)
        name = str(dtype).replace("torch.", "")
        log(f"[train] one {name} AdvMix step (SGD, TF32 off, batch 4) on the "
            f"card vs the CPU, difference of the parameters after the step "
            f"over their update: D max {r['d']['max']:.3g} (limit "
            f"{lim['d']:g}) 2-norm {r['d']['l2']:.3g}; G max "
            f"{r['g']['max']:.3g} (limit {lim['g']:g}) 2-norm "
            f"{r['g']['l2']:.3g}; loss_d {r['card']['loss_d']:.7f} vs "
            f"{r['cpu']['loss_d']:.7f}, loss_g {r['card']['loss_g']:.7f} vs "
            f"{r['cpu']['loss_g']:.7f}")
        if not (r["d"]["max"] < lim["d"] and r["g"]["max"] < lim["g"]):
            raise AssertionError(f"{name} step on the card vs the CPU: {r}")
        torch.cuda.empty_cache()

    # timings, bf16, after warm-up (cuDNN autotunes in the warm-up)
    for batch_size in (32, 128):
        t = time_advmix_largest_fit(cfg, dev, batch_size, torch.bfloat16,
                                    iters=10, inspect=profile_by_family)
        note = ("" if t["batch"] == t["asked"] else
                f" (batch {t['asked']} does not fit in the card's memory; "
                "the largest power of two that does)")
        log(f"[train] AdvMix bf16 batch {t['batch']}{note}: view synthesis "
            f"{t['views_ms']:.3f} ms, step {t['step_ms']:.3f} ms, both "
            f"{t['both_ms']:.3f} ms/iteration = {t['img_per_s']:.1f} img/s; "
            f"peak device memory {t['peak_gib']:.2f} GiB; loss_d "
            f"{t['loss_d']:.5f} loss_g {t['loss_g']:.5f}")
        if not (np.isfinite(t["loss_d"]) and np.isfinite(t["loss_g"])):
            raise AssertionError("the timed step's losses are not finite")
        prof = t["inspect"]
        log(f"[train] batch {t['batch']} profile of 2 iterations: wall "
            f"{prof['wall_ms']:.3f} ms/iteration, device busy "
            f"{prof['busy_ms']:.3f} ms ({100 * prof['busy_share']:.1f}%), "
            f"{prof['kernels']} kernels per iteration")
        for fam, (ms, n) in prof["families"].items():
            log(f"[train]   {ms:9.3f} ms/iteration {n:6d} launches  {fam}")
        for name, ms, n in prof["top"]:
            log(f"[train]   top: {ms:9.3f} ms/iteration {n:6d} launches  "
                f"{name}")
    return launches



# ---------------------------------------------------------------------------
# phase 6: corruptions on the card
# ---------------------------------------------------------------------------

SWEEP_SHAPE = (128, 256, 192, 3)  # an eval batch of crops, NHWC


def has_cv2() -> bool:
    try:
        import cv2  # noqa: F401
    except ImportError:
        return False
    return True


def deterministic_cases(with_cv2: bool):
    """(name, severity, exact_render) of every corruption form that draws
    nothing at random: the key-free types and the exact-render forms
    (spatter's water arm, severities 1-3, needs cv2)."""
    from advmix_tpu_torch.ops import corruptions as C

    cases = [(n, s, False) for n in C.ALL_CORRUPTIONS if n not in C.DRAWS
             for s in range(1, 6)]
    cases += [(n, s, True) for n in ("glass_blur", "motion_blur", "snow",
                                     "elastic_transform")
              for s in range(1, 6)]
    cases += [("spatter", s, True) for s in ((1, 2, 3, 4, 5) if with_cv2
                                             else (4, 5))]
    return cases


def card_vs_cpu(x_cpu: torch.Tensor, dev, name: str, severity: int,
                exact: bool) -> tuple[int, float]:
    """One corruption on the card and on the CPU, compared in uint8 after
    clip and truncation: (largest level difference, share of values that
    differ)."""
    from advmix_tpu_torch.ops.corruptions import corrupt

    def u8(x):
        return corrupt(x, name, severity, exact_render=exact).clamp(
            0, 255).to(torch.uint8).cpu().to(torch.int16)

    d = (u8(x_cpu.to(dev)) - u8(x_cpu)).abs()
    return int(d.max()), float((d > 0).float().mean())


def corruption_phase(dev) -> dict:
    """Phase 6. Returns {(name, form): (wall ms, device ms, launches)} at
    SWEEP_SHAPE."""
    from advmix_tpu_torch.ops import corruptions as C

    cv2_ok = has_cv2()
    log(f"[corrupt] import cv2 on this machine: "
        f"{'works' if cv2_ok else 'fails'}; spatter's exact water arm "
        f"(severities 1-3) is {'checked' if cv2_ok else 'left out'}")
    x = torch.from_numpy(np.random.RandomState(SEED + 10).randint(
        0, 256, (4, 256, 192, 3)).astype(np.float32))
    prev = (torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    # torch's default for cuDNN, and TF32 matmuls allowed: the module must
    # keep TF32 out of its own convolutions and matmuls (it sums them in f64)
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    worst: dict = {}
    bad = []
    try:
        t0 = time.perf_counter()
        for name, sev, exact in deterministic_cases(cv2_ok):
            lv, share = card_vs_cpu(x, dev, name, sev, exact)
            key = f"{name}{' (exact render)' if exact else ''}"
            w = worst.get(key, (0, 0.0, []))
            worst[key] = (max(w[0], lv), max(w[1], share), w[2] + [sev])
            if lv > 1 or share > 0.005:
                bad.append(f"{key} severity {sev}: {lv} levels on "
                           f"{100 * share:.3f}% of values")
        if torch.backends.cudnn.allow_tf32 is not True or \
                torch.get_float32_matmul_precision() != "high":
            raise AssertionError("corrupt changed the caller's TF32 settings")
    finally:
        torch.backends.cudnn.allow_tf32 = prev[0]
        torch.set_float32_matmul_precision(prev[1])
    for key, (lv, share, sevs) in worst.items():
        log(f"[corrupt] card vs CPU, {key}, severities "
            f"{','.join(map(str, sevs))}: largest difference {lv} uint8 "
            f"level(s), {100 * share:.4f}% of values differ at worst "
            "(limit 1 level, 0.5%; cuDNN TF32 on, matmul precision 'high')")
    log(f"[corrupt] card vs CPU on {tuple(x.shape)}: "
        f"{time.perf_counter() - t0:.1f} s")
    if bad:
        raise AssertionError("the card differs from the CPU by more than 1 "
                             "uint8 level or on more than 0.5% of values: "
                             + "; ".join(bad))

    # the traced forms of all 19 types, the 6 random-only ones among them
    xd = x.to(dev)
    for name in C.ALL_CORRUPTIONS:
        for sev in range(1, 6):
            outs = [C.corrupt(xd, name, sev,
                              torch.Generator(dev).manual_seed(seed))
                    for seed in (1, 2)]
            for out in outs:
                if out.shape != xd.shape or not torch.isfinite(out).all() \
                        or float(out.min()) < 0 or float(out.max()) > 255:
                    raise AssertionError(f"{name} severity {sev}: output "
                                         "not finite or out of [0, 255]")
            if name in C.DRAWS and torch.equal(outs[0], outs[1]):
                raise AssertionError(f"{name} severity {sev}: two seeds "
                                     "gave the same output")
    log(f"[corrupt] traced forms of all 19 types at severities 1..5 on the "
        f"card: shape, finite, in [0, 255]; the {len(C.DRAWS)} random ones "
        "differ between two seeds")

    # timings at the sweep's shape, severity 3
    big = torch.randint(0, 256, SWEEP_SHAPE, generator=torch.Generator(
        dev).manual_seed(SEED), device=dev).to(torch.float32)
    forms = [(n, False) for n in C.ALL_CORRUPTIONS] + [
        (n, True) for n in C.EXACT_RENDER]
    out = {}
    for name, exact in forms:
        sev = 3 if (cv2_ok or name != "spatter" or not exact) else 4
        gen = torch.Generator(dev).manual_seed(1)

        def fn(name=name, exact=exact, sev=sev, gen=gen):
            return C.corrupt(big, name, sev, gen, exact_render=exact)

        wall = wall_ms(fn, iters=5)  # its warm-up fills the constant cache
        # a profiler window of a few ms can lose its kernels: profile
        # enough calls for ~100 ms and take the mean per call
        steps = max(3, min(50, int(100.0 / max(wall, 1e-3)) + 1))
        _, by_name = profiled(fn, steps=steps)
        busy = sum(t for t, _ in by_name.values()) / steps / 1e3
        n = sum(k for _, k in by_name.values()) / steps
        form = "exact render" if exact else "traced"
        out[name, form] = (wall, busy, n)
        log(f"[corrupt] {name:17s} {form:12s} severity {sev} "
            f"{SWEEP_SHAPE}: {wall:9.3f} ms per call (CUDA events, host "
            f"included), device {busy:9.3f} ms, {n:7.1f} launches per call "
            f"(profiler, mean of {steps} calls)")
    del big, xd
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 7 and 8: the sweep and --random_corruption training
# ---------------------------------------------------------------------------

def run_sweep(argv, build, kernel_fns, n_pass: int = 1 + 15 * 5) -> dict:
    """`tools/test_corruption.main(argv)`, each pass timed by the host clock
    up to a sync at its end, and each corruption by CUDA events on the
    stream, read after the sweep (no sync added to a pass). Returns the
    result, the kernels' launches, the wall seconds, the seconds of every
    pass and of every corruption."""
    import advmix_tpu_torch.engine.trainer as trainer_mod
    from advmix_tpu_torch.tools import test_corruption as sweep_tool

    pass_s, corrupt_ev = [], []
    real_validate, real_corrupt = sweep_tool.validate, trainer_mod.corrupt
    real_bottomup = trainer_mod.validate_bottomup

    def timed(fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            res = fn(*a, **k)
            torch.cuda.synchronize()
            pass_s.append(time.perf_counter() - t0)
            return res
        return run

    def timed_corrupt(*a, **k):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        res = real_corrupt(*a, **k)
        ev[1].record()
        corrupt_ev.append(ev)
        return res

    sweep_tool.validate, trainer_mod.corrupt = (timed(real_validate),
                                                timed_corrupt)
    trainer_mod.validate_bottomup = timed(real_bottomup)
    for fn in kernel_fns:
        fn.launches = 0
    t0 = time.perf_counter()
    try:
        if build is None:
            result = sweep_tool.main(argv)
        else:
            result = sweep_tool.main(argv, build_dataset=build)
    finally:
        sweep_tool.validate, trainer_mod.corrupt = real_validate, real_corrupt
        trainer_mod.validate_bottomup = real_bottomup
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernel_fns}
    torch.cuda.synchronize()
    if len(result["runs"]) != n_pass or len(pass_s) != n_pass:
        raise AssertionError(f"the sweep ran {len(result['runs'])} passes")
    with open(os.path.join(result["output_dir"], "robust_C.val")) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    if len(lines) != n_pass:
        raise AssertionError(f"robust_C.val has {len(lines)} lines")
    perfs = [r[3] for r in result["runs"]]
    if not all(np.isfinite(a) for a in perfs):
        raise AssertionError(f"a pass scored {perfs}")
    return dict(result=result, launches=launches, wall=wall, pass_s=pass_s,
                corrupt_s=[a.elapsed_time(b) / 1e3 for a, b in corrupt_ev])


def log_sweep_times(tag: str, sw: dict) -> None:
    pass_s, corrupt_s = sw["pass_s"], sw["corrupt_s"]
    steady = pass_s[1:]
    log(f"[{tag}] s/pass: first (clean, cuDNN autotuning) {pass_s[0]:.3f}, "
        f"the other {len(steady)} mean {mean(steady):.3f} (min "
        f"{min(steady):.3f}, max "
        f"{max(steady):.3f}); corruption {sum(corrupt_s):.3f} s in all = "
        f"{100 * sum(corrupt_s) / sum(steady):.1f}% of the corrupted passes "
        f"({mean(corrupt_s) * 1e3:.1f} ms per pass: CUDA events around "
        "each corrupt call on the stream, no sync added to the pass)")


def sweep_phase(dev, tmp: str, start_path: str, dataset_cls,
                kernel_fns) -> dict:
    """Phase 7. Returns the kernels' launch counts on the sweep."""
    import csv

    root = os.path.join(tmp, "sweep")
    counts = write_coco(root, "val2017", [int(c) for c in np.random.RandomState(
        SEED + 20).randint(2, 9, 20)], np.random.RandomState(SEED + 21))
    argv = ["--cfg", CFG, "--on_the_fly", "--device", str(dev),
            "--modelDir", os.path.join(tmp, "sweep_out"),
            "--logDir", os.path.join(tmp, "sweep_log"), "DATASET.ROOT", root,
            "TEST.MODEL_FILE", start_path]

    def build(cfg, is_train, image_set=None):
        return dataset_cls(cfg, is_train, image_set)

    sw = run_sweep(argv, build, kernel_fns)
    result, launches = sw["result"], sw["launches"]
    n_pass = 1 + 15 * 5
    n_batches = -(-sum(counts) // 128)
    log(f"[sweep] tools/test_corruption.main --on_the_fly: {n_pass} passes "
        f"over {sum(counts)} people in {len(counts)} images ({n_batches} "
        f"batch of 128) in {sw['wall']:.2f} s, launches {launches}")
    with open(result["csv"]) as f:
        row = next(csv.DictReader(f))
    for k in ("clean_mAP", "mean_corrupted_mAP", "rAP"):
        if not np.isfinite(float(row[k])):
            raise AssertionError(f"CSV {k} = {row[k]} is not finite")
    if launches["decode_heatmaps"] != n_pass * n_batches:
        raise AssertionError(f"decode launched {launches['decode_heatmaps']}"
                             f" times, expected {n_pass * n_batches}")
    if launches["oks_matrix_batched"] != n_pass:
        raise AssertionError(f"batched OKS launched "
                             f"{launches['oks_matrix_batched']} times, "
                             f"expected {n_pass}")
    log(f"[sweep] robust_C.val {n_pass} lines; CSV clean_mAP "
        f"{row['clean_mAP']} mean_corrupted_mAP {row['mean_corrupted_mAP']} "
        f"rAP {row['rAP']} (random weights)")
    log_sweep_times("sweep", sw)
    return launches


def random_corruption_train_phase(dev, tmp: str, start_path: str,
                                  dataset_cls, kernel_fns) -> dict:
    """Phase 8. Returns the kernels' launch counts on this training run."""
    from advmix_tpu_torch.tools import train as train_tool

    root = os.path.join(tmp, "sweep")  # phase 7 wrote its val set there
    write_coco(root, "train2017", [4] * 16, np.random.RandomState(SEED + 22))
    argv = ["--cfg", CFG, "--random_corruption", "--device", str(dev),
            "--load_from_D", start_path,
            "--modelDir", os.path.join(tmp, "rc_out"), "--logDir",
            os.path.join(tmp, "rc_log"), "DATASET.ROOT", root,
            "TRAIN.END_EPOCH", "1", "PRINT_FREQ", "1"]

    def build(cfg, is_train, image_set=None):
        return dataset_cls(cfg, is_train, image_set)

    for fn in kernel_fns:
        fn.launches = 0
    t0 = time.perf_counter()
    result = train_tool.main(argv, build_dataset=build)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernel_fns}
    history = result["history"]
    if len(history) != 1 or len(history[0]) != 2:
        raise AssertionError(f"trained {[len(h) for h in history]} "
                             "iterations, expected one epoch of 2")
    for i, m in enumerate(history[0]):
        if not (np.isfinite(m["loss"]) and m["loss"] > 0):
            raise AssertionError(f"iteration {i}: loss {m['loss']}")
    start = torch.load(start_path, map_location="cpu")
    sd = {k: v.cpu() for k, v in result["state"].model.state_dict().items()}
    floats = [k for k, v in sd.items() if v.is_floating_point()]
    changed = sum(not torch.equal(sd[k], start[k]) for k in floats)
    if changed < 0.9 * len(floats):
        raise AssertionError(f"only {changed} of {len(floats)} tensors moved")
    losses = ", ".join(f"{m['loss']:.6f}" for m in history[0])
    log(f"[train] tools/train.main --random_corruption, 1 epoch of 2 "
        f"iterations of batch 32 + validate(): {wall:.2f} s; losses "
        f"{losses}; {changed} of {len(floats)} tensors of the model changed; "
        f"launches {launches}")
    del result
    torch.cuda.empty_cache()
    return launches


def random_model(cfg, where: torch.device):
    """cfg's model on `where`, f32, eval mode: He-normal convs from a
    generator seeded SEED, and BN running stats from the batch statistics
    of seeded random images, so that every layer's activations, and the
    heatmaps, are O(1)."""
    from advmix_tpu_torch.models import get_pose_net, he_reinit_convs

    model = get_pose_net(cfg)
    he_reinit_convs(model, torch.Generator().manual_seed(SEED))
    w, h = cfg.MODEL.IMAGE_SIZE
    calib = torch.from_numpy(np.random.RandomState(SEED + 2).randint(
        0, 256, (4, 3, h, w)).astype(np.float32) / 64.0 - 2.0)
    model = model.to(where)
    for mod in model.modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            mod.reset_running_stats()
            mod.momentum = None  # cumulative: one batch sets the stats
    model.train()
    with torch.no_grad():
        model(calib.to(where))
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                # a channel nearly dead on the calibration batch would
                # otherwise get a gain of up to 1/sqrt(eps)
                mod.running_var.clamp_(min=1e-2)
    return model.eval()


def first_batch(loader, prep, dev) -> dict:
    """The eval step's device batch of the loader's first batch."""
    from advmix_tpu_torch.engine.trainer import to_device

    batches = iter(loader)
    host = next(batches)
    batches.close()  # shuts the loader's thread pool down
    batch = prep(to_device(host["image"], dev), to_device(host["joints"], dev),
                 to_device(host["joints_vis"], dev))
    batch.update(center=to_device(host["center"].astype(np.float32), dev),
                 scale=to_device(host["scale"].astype(np.float32), dev))
    return batch


def launch_counts(kernel_fns) -> dict:
    return {fn.__name__: fn.launches for fn in kernel_fns}


def log_families(tag: str, prof: dict) -> None:
    for fam, (ms, n) in prof["families"].items():
        log(f"[{tag}]   {ms:9.3f} ms/step {n:6d} launches  {fam}")
    for name, ms, n in prof["top"]:
        log(f"[{tag}]   top: {ms:9.3f} ms/step {n:6d} launches  {name}")


# ---------------------------------------------------------------------------
# phase 9: the other COCO families
# ---------------------------------------------------------------------------

FAMILIES = (
    ("HRNet-W48", "experiments/coco/hrnet/w48_256x192_advmix.yaml"),
    ("ResNet-50", "experiments/coco/resnet/res50_256x192_advmix.yaml"),
    ("ResNet-101", "experiments/coco/resnet/res101_256x192_advmix.yaml"),
    ("ResNet-152", "experiments/coco/resnet/res152_256x192_advmix.yaml"),
)
EVAL_BATCH = 128


def families_phase(dev, tmp: str, dataset_cls, kernel_fns) -> dict:
    """Phase 9. Each family's YAML at full width and depth, seeded random
    weights, bf16, flip test, batch 128, through validate() on phase 4's
    val set; then one batch timed and profiled. Returns the kernels' launch
    counts summed over the four passes."""
    from advmix_tpu_torch.config import get_default_config
    from advmix_tpu_torch.data import Loader
    from advmix_tpu_torch.engine.steps import make_eval_step
    from advmix_tpu_torch.engine.trainer import make_eval_preprocessor, \
        validate
    from advmix_tpu_torch.models.layers import set_compute_dtype

    total = {fn.__name__: 0 for fn in kernel_fns}
    for name, rel in FAMILIES:
        cfg = get_default_config()
        cfg.merge_from_file(os.path.join(HERE, rel))
        cfg.DATASET.ROOT = tmp
        cfg.TEST.BATCH_SIZE_PER_GPU = EVAL_BATCH  # W48's YAML has 64
        cfg.freeze()
        dataset = dataset_cls(cfg, is_train=False)
        loader = Loader(dataset, EVAL_BATCH)
        model = random_model(cfg, dev)
        card_matches_cpu(name, model, dev, cfg.MODEL.IMAGE_SIZE)
        set_compute_dtype(model, torch.bfloat16)
        eval_step = make_eval_step(model, cfg, dataset.flip_pairs)
        prep = make_eval_preprocessor(cfg, dev)
        torch.cuda.reset_peak_memory_stats()

        for fn in kernel_fns:
            fn.launches = 0
        t0 = time.perf_counter()
        _, ap = validate(cfg, eval_step, prep, dataset, loader,
                         os.path.join(tmp, "out_" + name), dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts(kernel_fns)
        if launches["decode_heatmaps"] != len(loader):
            raise AssertionError(f"{name}: decode launched "
                                 f"{launches['decode_heatmaps']} times for "
                                 f"{len(loader)} batches")
        for k in ("oks_matrix_batched", "oks_matrix"):
            if launches[k] < 1:
                raise AssertionError(f"{name}: {k} was not launched")
        if not (np.isfinite(ap) and -1.0 <= ap <= 1.0):
            raise AssertionError(f"{name}: AP {ap} is not a valid score")
        for k in total:
            total[k] += launches[k]

        batch = first_batch(loader, prep, dev)
        preds, maxvals, _ = eval_step(batch)
        if preds.shape != (EVAL_BATCH, 17, 2) or not (
                torch.isfinite(preds).all() and torch.isfinite(maxvals).all()):
            raise AssertionError(f"{name}: preds {tuple(preds.shape)} not "
                                 "finite")
        ms = wall_ms(lambda: eval_step(batch))
        prof = profile_by_family(lambda: eval_step(batch), steps=3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"[families] {name} ({rel}): validate() {wall:.2f} s over "
            f"{len(dataset)} people, COCO eval {dataset.eval_seconds:.3f} s, "
            f"AP {ap:.4f} (random weights), launches {launches}")
        log(f"[families] {name} eval step (2 bf16 forwards + decode) at "
            f"batch {EVAL_BATCH}: {ms:.3f} ms/batch, "
            f"{EVAL_BATCH / ms * 1e3:.1f} img/s; profile of 3 steps: wall "
            f"{prof['wall_ms']:.3f} ms/step, device busy "
            f"{prof['busy_ms']:.3f} ms ({100 * prof['busy_share']:.1f}%), "
            f"{prof['kernels']} kernels per step; peak device memory "
            f"{peak:.2f} GiB")
        if name == "ResNet-152":
            log_families("families", prof)
        del model, eval_step, batch, preds, maxvals
        torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# phase 10: MPII at full width
# ---------------------------------------------------------------------------

MPII_CFG = os.path.join(HERE, "experiments/mpii/hrnet/w32_256x256_advmix.yaml")
MPII_JOINTS = ("rank", "rkne", "rhip", "lhip", "lkne", "lank", "pelvis",
               "thorax", "upper neck", "head", "rwri", "relb", "rsho", "lsho",
               "lelb", "lwri")
MPII_SHAPE = (EVAL_BATCH, 16, 64, 64)
DEBUG_OPTS = ["DEBUG.DEBUG", "True", "DEBUG.SAVE_BATCH_IMAGES_GT", "True",
              "DEBUG.SAVE_BATCH_IMAGES_PRED", "True",
              "DEBUG.SAVE_HEATMAPS_GT", "True",
              "DEBUG.SAVE_HEATMAPS_PRED", "True"]


def write_mpii(root: str, image_set: str, n: int, rng,
               per_image: int = 2) -> None:
    """annot/<image_set>.json of n people, `per_image` to a 640x480 JPEG of
    seeded noise, 1-based as the MPII release stores them; for the valid set
    also annot/gt_valid.mat (scipy.io.savemat) with some joints missing."""
    import cv2
    from scipy.io import savemat

    os.makedirs(os.path.join(root, "annot"), exist_ok=True)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    for i in range(-(-n // per_image)):
        cv2.imwrite(os.path.join(root, "images", f"{image_set}_{i:05d}.jpg"),
                    rng.randint(0, 256, (480, 640, 3)).astype(np.uint8))
    anno = []
    pos, head, missing = np.zeros((16, 2, n)), np.zeros((2, 2, n)), \
        np.zeros((16, n))
    for k in range(n):
        scale = rng.uniform(1.0, 1.8)  # a box 200 * scale px high
        c = np.array([rng.uniform(160, 480), rng.uniform(160, 320)])
        joints = c + rng.uniform(-0.4, 0.4, (16, 2)) * 200 * scale
        vis = (rng.rand(16) > 0.1).astype(int)
        anno.append(dict(image=f"{image_set}_{k // per_image:05d}.jpg",
                         center=c.tolist(), scale=scale,
                         joints=joints.tolist(), joints_vis=vis.tolist()))
        pos[:, :, k] = joints
        missing[:, k] = 1 - vis
        half = 0.15 * 200 * scale
        head[:, :, k] = [joints[9] - half, joints[9] + half]
    with open(os.path.join(root, "annot", f"{image_set}.json"), "w") as f:
        json.dump(anno, f)
    if image_set == "valid":
        names = np.zeros((1, 16), object)
        names[0, :] = MPII_JOINTS
        savemat(os.path.join(root, "annot", "gt_valid.mat"),
                dict(dataset_joints=names, jnt_missing=missing,
                     pos_gt_src=pos, headboxes_src=head))


def decode_shape_phase(dev, rng, flush, shape) -> dict:
    """The decode kernel at `shape` against its plain version, bit for bit:
    the wrapper (vector route), the wrapper on a 4-byte aligned view (scalar
    route) and each route forced, with and without the quarter offset; then
    routes, wrapper and plain version timed in turns with a cold L2."""
    from advmix_tpu_torch.ops.cuda.decode_kernel import (
        decode_heatmaps, decode_heatmaps_plain, decode_route)
    from advmix_tpu_torch.ops.cuda.timing import decode_by

    b, j, h, w = shape
    hm = torch.from_numpy(decode_inputs(rng, b, j, h, w)).to(dev)
    shifted = torch.empty(hm.numel() + 1, device=dev)[1:].view_as(hm)
    shifted.copy_(hm)
    if decode_route(h, w, hm.data_ptr()) != "vector" or decode_route(
            h, w, shifted.data_ptr()) != "scalar":
        raise AssertionError(f"decode_route at {shape}: aligned maps must "
                             "take the vector route, the shifted view the "
                             "scalar one")
    err = 0.0
    for post in (True, False):
        cp, mp = decode_heatmaps_plain(hm, post_process=post)
        runs = {"wrapper": decode_heatmaps(hm, post),
                "wrapper, shifted view": decode_heatmaps(shifted, post),
                "scalar": decode_by("scalar", hm, post),
                "vector": decode_by("vector", hm, post)}
        torch.cuda.synchronize()
        for name, got in runs.items():
            if not (torch.equal(got[0], cp) and torch.equal(got[1], mp)):
                bad = (got[0] != cp).any(-1).nonzero()[:5].tolist()
                raise AssertionError(f"decode {name} at {shape} (post="
                                     f"{post}) differs from the plain version "
                                     f"at maps {bad}")
        fin = torch.isfinite(mp)
        ck, mk = runs["wrapper"]
        err = max(err, float((ck - cp).abs().max()),
                  float((mk - mp)[fin].abs().max()))
    log(f"[kernels] decode {shape}: the wrapper, the wrapper on a 4-byte "
        "aligned view and both routes forced are bit-equal to the plain "
        "version (random, ties, bf16, zero, negative, -inf, border peaks)")
    hm_main = torch.randn(*shape, device=dev)
    nb, by = bound(b * j * h * w * 4 + b * j * 3 * 4, b * j * h * w)
    fns = {r: (lambda r=r: decode_by(r, hm_main)) for r in ("scalar",
                                                            "vector")}
    fns["wrapper"] = lambda: decode_heatmaps(hm_main)
    fns["plain"] = lambda: decode_heatmaps_plain(hm_main)
    times = {k: mean(v) for k, v in in_turns(fns, flush).items()}
    for name, t in times.items():
        log(f"[kernels] decode {shape} cold L2, {name}: {t:.5f} ms = "
            f"{100 * nb / t:.1f}% of the bound {nb:.5f} ms ({by})")
    return dict(shape=f"{shape} f32, MPII's eval batch, cold L2",
                max_abs_err=err, ms=times["wrapper"],
                plain_ms=times["plain"], bound_ms=nb, bound_by=by,
                scalar_route_ms=times["scalar"])


def mpii_phase(dev, tmp: str, kernel_fns, rng, flush) -> dict:
    """Phase 10. Returns the kernels' launches on the MPII training run and
    on the MPII sweep, and the decode kernel's check and times at MPII's
    shape. The YAML computes in f32: its training, sweep and timings run
    with cuDNN's TF32 on, torch's default, as a user runs them."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        out = mpii_paths(dev, tmp, kernel_fns)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    out["decode"] = decode_shape_phase(dev, rng, flush, MPII_SHAPE)
    return out


def mpii_paths(dev, tmp: str, kernel_fns) -> dict:
    import csv

    import advmix_tpu_torch.engine.trainer as trainer_mod
    from advmix_tpu_torch.config import get_default_config
    from advmix_tpu_torch.tools import train as train_tool
    from advmix_tpu_torch.tools.bench import time_advmix

    base = os.path.join(tmp, "mpii")
    root = os.path.join(base, "mpii")
    # 48 + 48 stylized training people: only the union makes the 3 batches
    # of 32 that drop_last leaves
    write_mpii(root, "train", 48, np.random.RandomState(SEED + 30))
    write_mpii(root, "valid", EVAL_BATCH, np.random.RandomState(SEED + 31))
    write_mpii(os.path.join(base, "stylize_image_mpii"), "train", 48,
               np.random.RandomState(SEED + 32))
    cfg = get_default_config()
    cfg.merge_from_file(MPII_CFG)
    cfg.freeze()
    # D and the teacher start from seeded weights with calibrated BN, as
    # phase 5's do: an eval-mode teacher on raw He-normal weights explodes
    start = os.path.join(tmp, "mpii_start.pth")
    torch.save(random_model(cfg, dev).state_dict(), start)
    out_dir = os.path.join(tmp, "mpii_out")
    argv = ["--cfg", MPII_CFG, "--advmix", "--sample_times", "3",
            "--stylize_image", "--sp_style", "1", "--device", str(dev),
            "--load_from_D", start, "--modelDir", out_dir,
            "--logDir", os.path.join(tmp, "mpii_log"), "DATASET.ROOT", root,
            "TRAIN.END_EPOCH", "1", "TEST.BATCH_SIZE_PER_GPU",
            str(EVAL_BATCH), *DEBUG_OPTS]
    dump_s = {"train": [], "val": []}
    real_dumps = (trainer_mod._dump_debug_images,
                  trainer_mod._dump_val_debug_images)

    def timed(kind, fn):
        def wrapped(*a, **k):
            t = time.perf_counter()
            fn(*a, **k)
            dump_s[kind].append(time.perf_counter() - t)
        return wrapped

    trainer_mod._dump_debug_images = timed("train", real_dumps[0])
    trainer_mod._dump_val_debug_images = timed("val", real_dumps[1])
    for fn in kernel_fns:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        result = train_tool.main(argv)
    finally:
        (trainer_mod._dump_debug_images,
         trainer_mod._dump_val_debug_images) = real_dumps
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    final_state = result["final_state"]
    train_launches = launch_counts(kernel_fns)
    peak = torch.cuda.max_memory_allocated() / 2**30
    history = result["history"]
    if len(history) != 1 or len(history[0]) != TRAIN_ITERS:
        raise AssertionError(f"MPII: trained {[len(h) for h in history]} "
                             f"iterations, expected {TRAIN_ITERS}")
    for i, m in enumerate(history[0]):
        if not (np.isfinite(m["loss_d"]) and np.isfinite(m["loss_g"])
                and m["loss_d"] > 0 and m["loss_g"] < 0):
            raise AssertionError(f"MPII iteration {i}: losses {m}")
    if not (np.isfinite(result["perf"]) and 0.0 <= result["perf"] <= 100.0):
        raise AssertionError(f"MPII PCKh Mean {result['perf']}")
    if train_launches != {"decode_heatmaps": 1, "oks_matrix_batched": 0,
                          "oks_matrix": 0}:
        raise AssertionError(f"MPII training launches {train_launches}: "
                             "one validation batch decodes, PCKh has no NMS")
    debug_dir = os.path.join(out_dir, "mpii", "pose_hrnet", "debug")
    want = {f"{p}_{f}.jpg" for p in ("train_0_0", "train_0_0_mixed", "val_0")
            for f in ("gt", "pred", "hm_gt", "hm_pred")}
    got = set(os.listdir(debug_dir)) if os.path.isdir(debug_dir) else set()
    if got != want:
        raise AssertionError(f"debug dumps {sorted(got)}, expected "
                             f"{sorted(want)}")
    if not os.path.isfile(os.path.join(result["output_dir"], "pred.mat")):
        raise AssertionError("validate() wrote no pred.mat")
    losses = ", ".join(f"{m['loss_d']:.6f}/{m['loss_g']:.6f}"
                       for m in history[0])
    log(f"[mpii] tools/train.main {os.path.relpath(MPII_CFG, HERE)} --advmix "
        f"--sample_times 3 --stylize_image --sp_style 1 DEBUG.DEBUG True "
        f"(f32 per the YAML, cuDNN TF32 on; cuDNN autotuning included), 1 "
        f"epoch of {TRAIN_ITERS} iterations of batch "
        f"32 over 48 + 48 stylized people + validate() on {EVAL_BATCH}: "
        f"{wall:.2f} s, peak device memory {peak:.2f} GiB; loss_d/loss_g "
        f"{losses}; PCKh Mean {result['perf']:.4f} (random weights); "
        f"{len(got)} dump files; launches {train_launches}")
    log(f"[mpii] DEBUG dumps (host clock around each, the read-back "
        f"included): training {', '.join(f'{x:.3f}' for x in dump_s['train'])}"
        f" s for a batch of 32 (the input and the mix), validation "
        f"{', '.join(f'{x:.3f}' for x in dump_s['val'])} s for a batch of "
        f"{EVAL_BATCH}")
    del result
    torch.cuda.empty_cache()

    t = time_advmix(cfg, dev, 32, torch.float32, iters=5,
                    inspect=profile_by_family)
    prof = t["inspect"]
    log(f"[mpii] AdvMix f32 batch 32 at 256x256 (tools/bench.time_advmix, "
        f"cuDNN TF32 on): view synthesis {t['views_ms']:.3f} ms, step "
        f"{t['step_ms']:.3f} ms, both {t['both_ms']:.3f} ms/iteration = "
        f"{t['img_per_s']:.1f} img/s; peak device memory "
        f"{t['peak_gib']:.2f} GiB; profile of 2 iterations: device busy "
        f"{prof['busy_ms']:.3f} ms ({100 * prof['busy_share']:.1f}%), "
        f"{prof['kernels']} kernels per iteration")
    torch.cuda.empty_cache()

    argv = ["--cfg", MPII_CFG, "--on_the_fly", "--device", str(dev),
            "--modelDir", os.path.join(tmp, "mpii_sweep_out"), "--logDir",
            os.path.join(tmp, "mpii_sweep_log"), "DATASET.ROOT", root,
            "TEST.MODEL_FILE", final_state, "TEST.BATCH_SIZE_PER_GPU",
            str(EVAL_BATCH)]
    sw = run_sweep(argv, None, kernel_fns)
    n_pass = 1 + 15 * 5
    if sw["launches"] != {"decode_heatmaps": n_pass, "oks_matrix_batched": 0,
                          "oks_matrix": 0}:
        raise AssertionError(f"MPII sweep launches {sw['launches']}")
    with open(sw["result"]["csv"]) as f:
        row = next(csv.DictReader(f))
    for k in ("clean_mean", "mean_corrupted_mean", "rmean"):
        if not np.isfinite(float(row[k])):
            raise AssertionError(f"MPII CSV {k} = {row[k]} is not finite")
    mats = [n for n in os.listdir(sw["result"]["output_dir"])
            if n.endswith("_pred.mat")]
    if len(mats) != n_pass:
        raise AssertionError(f"{len(mats)} pred.mat files for {n_pass} "
                             "passes")
    log(f"[mpii] tools/test_corruption.main --on_the_fly: {n_pass} passes "
        f"over {EVAL_BATCH} people (one batch) in {sw['wall']:.2f} s, "
        f"launches {sw['launches']}; CSV clean_mean {row['clean_mean']} "
        f"mean_corrupted_mean {row['mean_corrupted_mean']} rmean "
        f"{row['rmean']} (random weights)")
    log_sweep_times("mpii", sw)
    return dict(train=train_launches, sweep=sw["launches"])


# ---------------------------------------------------------------------------
# phase 11: soft-argmax
# ---------------------------------------------------------------------------

SOFT_TOL_PX = 1e-3  # card vs CPU, heatmap px


def peaked_maps(rng, b, j, h, w) -> np.ndarray:
    """Noise plus one Gaussian peak per map at a sub-pixel position, some
    off the map: the soft-argmax lands between pixels."""
    yy, xx = np.mgrid[0:h, 0:w]
    cx = rng.uniform(-2, w + 1, (b, j, 1, 1))
    cy = rng.uniform(-2, h + 1, (b, j, 1, 1))
    s = rng.uniform(1.0, 3.0, (b, j, 1, 1))
    a = rng.uniform(0.2, 1.0, (b, j, 1, 1))
    return (rng.rand(b, j, h, w) * 0.05 + a * np.exp(
        -((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s))).astype(np.float32)


def soft_argmax_phase(dev, tmp: str, start_path: str, dataset_cls,
                      kernel_fns) -> dict:
    """Phase 11. Returns the kernels' launches on the soft-argmax pass and
    the times."""
    from advmix_tpu_torch.config import get_default_config
    from advmix_tpu_torch.data import Loader
    from advmix_tpu_torch.engine.steps import make_eval_step
    from advmix_tpu_torch.engine.trainer import make_eval_preprocessor, \
        validate
    from advmix_tpu_torch.models import get_pose_net, load_model_file
    from advmix_tpu_torch.models.layers import set_compute_dtype
    from advmix_tpu_torch.ops.cuda.decode_kernel import decode_heatmaps
    from advmix_tpu_torch.ops.heatmap import get_final_preds_softargmax, \
        soft_argmax
    from advmix_tpu_torch.ops.transforms import transform_preds_batch

    cfgs = {}
    for soft in (False, True):
        cfg = get_default_config()
        cfg.merge_from_file(CFG)
        cfg.DATASET.ROOT = tmp
        cfg.TEST.SOFT_ARGMAX = soft
        cfg.freeze()
        cfgs[soft] = cfg
    model = get_pose_net(cfgs[True])
    load_model_file(model, start_path)  # phase 4's weights
    set_compute_dtype(model.to(dev).eval(), torch.bfloat16)
    dataset = dataset_cls(cfgs[True], is_train=False)
    loader = Loader(dataset, EVAL_BATCH)
    prep = make_eval_preprocessor(cfgs[True], dev)
    steps_ = {soft: make_eval_step(model, cfgs[soft], dataset.flip_pairs)
              for soft in (False, True)}

    for fn in kernel_fns:
        fn.launches = 0
    _, ap = validate(cfgs[True], steps_[True], prep, dataset, loader,
                     os.path.join(tmp, "out_soft"), dev)
    torch.cuda.synchronize()
    launches = launch_counts(kernel_fns)
    if launches["decode_heatmaps"] != 0 or launches["oks_matrix_batched"] < 1:
        raise AssertionError(f"TEST.SOFT_ARGMAX launches {launches}: the "
                             "decode kernel must not run, batched OKS must")
    if not (np.isfinite(ap) and -1.0 <= ap <= 1.0):
        raise AssertionError(f"TEST.SOFT_ARGMAX AP {ap}")
    log(f"[soft] validate() with TEST.SOFT_ARGMAX True: AP {ap:.4f} (random "
        f"weights), launches {launches}")

    batch = first_batch(loader, prep, dev)
    maps = {"W32 step's heatmaps": steps_[True].forward(batch["image"]),
            "peaked maps": torch.from_numpy(peaked_maps(
                np.random.RandomState(SEED + 40), *MPII_SHAPE)).to(dev)}
    times = {}
    for label, hm in maps.items():
        pc, mc = soft_argmax(hm)
        pr, mr = soft_argmax(hm.cpu())
        d = float((pc.cpu() - pr).abs().max())
        # a confidence is read at the rounded coordinate: it may differ only
        # where the two coordinates round apart
        near = ((pr - pr.floor() - 0.5).abs() < SOFT_TOL_PX).any(-1)
        off = (mc.cpu() != mr)[..., 0]
        if not (torch.isfinite(pc).all() and d <= SOFT_TOL_PX
                and not (off & ~near).any()):
            raise AssertionError(f"soft-argmax on the card vs the CPU, "
                                 f"{label} {tuple(hm.shape)}: max |diff| "
                                 f"{d:.3g} px (limit {SOFT_TOL_PX}), "
                                 f"{int(off.sum())} confidences differ")
        b, j, h, w = hm.shape
        center = batch["center"][:1].expand(b, 2).contiguous()
        scale = batch["scale"][:1].expand(b, 2).contiguous()

        def soft_fn(hm=hm, center=center, scale=scale):
            return get_final_preds_softargmax(hm, center, scale)

        def argmax_fn(hm=hm, center=center, scale=scale):
            coords, maxvals = decode_heatmaps(hm)
            return transform_preds_batch(coords, center, scale, (w, h))

        t = {k: mean(v) for k, v in in_turns(
            {"decode kernel + inverse affine": argmax_fn,
             "soft-argmax + quarter offset + inverse affine": soft_fn},
            iters=20).items()}
        times[label] = t
        log(f"[soft] {label} {tuple(hm.shape)}: card vs CPU coordinates "
            f"max |diff| {d:.3g} heatmap px (limit {SOFT_TOL_PX}), "
            f"{int(off.sum())} confidences read at a coordinate that rounds "
            "the other way; " + "; ".join(f"{k} {v:.5f} ms"
                                         for k, v in t.items())
            + " (CUDA events, 20 calls, warm L2)")
    step = in_turns({"argmax step": lambda: steps_[False](batch),
                     "soft-argmax step": lambda: steps_[True](batch)},
                    iters=10)
    log(f"[soft] W32 eval step at batch {EVAL_BATCH} in turns: "
        + "; ".join(f"{k} {a:.3f} / {b:.3f} ms" for k, (a, b) in step.items())
        + " (device time of 10 steps, CUDA events)")
    del model, steps_, batch, maps
    torch.cuda.empty_cache()
    return dict(launches=launches, times=times, step=step)


# ---------------------------------------------------------------------------
# phase 12: bottom-up HigherHRNet-W32 512x512
# ---------------------------------------------------------------------------

HIGHER_CFG = os.path.join(HERE,
                          "experiments/coco/higher_hrnet/w32_512_advmix.yaml")
OCHUMAN_CFG = os.path.join(
    HERE, "experiments/ochuman/higher_hrnet/w32_512_advmix.yaml")
# val2017 for validate; train2017 and train24 make 3 and 2 iterations of
# 12; val1 is what the training runs validate on (three steps move D's BN
# statistics off the heads' calibration, and the maps then hold 120-230
# groups per image, 6-10 s of host grouping each); val8 the sweep's batch
BU_SETS = {"val2017": 16, "train2017": 36, "train24": 24, "val1": 1,
           "val8": 8}
BU_PEAKS_PER_MAP = 4  # the heads' calibration: peaks above 0.1 per map
BU_TAG_SPREAD = 0.1
BU_SWEEP = ("zoom_blur", "defocus_blur")
BU_CHECK_SIZE = 256  # the float64 checks card vs CPU: input side


def rle_string(mask: np.ndarray) -> str:
    """pycocotools' compressed RLE string (mask.c rleToString) of a 0/1
    (h, w) mask: column-major runs starting with zeros, each count after
    the second delta-coded against the one two back, 5-bit groups."""
    flat = np.asarray(mask, np.uint8).T.reshape(-1)
    edges = np.flatnonzero(np.diff(flat)) + 1
    runs = np.diff(np.concatenate([[0], edges, [flat.size]])).tolist()
    counts = ([0] + runs) if flat[0] else runs
    out = []
    for i, c in enumerate(counts):
        x = int(c) - (int(counts[i - 2]) if i > 2 else 0)
        more = True
        while more:
            ch = x & 0x1F
            x >>= 5
            more = (x != -1) if (ch & 0x10) else (x != 0)
            out.append(chr((ch | (0x20 if more else 0)) + 48))
    return "".join(out)


def write_bottomup_coco(root: str, image_set: str, n_images: int,
                        rng) -> int:
    """A COCO-format bottom-up set: JPEGs of seeded noise with COCO file
    names (the image id is read from the name), 320..640 x 240..480, 1-6
    annotated people each (3..17 labelled joints), and per image one crowd
    region as a compressed RLE string and one zero-keypoint person as a
    polygon, so that the training ignore mask is real. Returns the number
    of annotated people."""
    import cv2

    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    os.makedirs(os.path.join(root, image_set), exist_ok=True)
    images, anns, n_people = [], [], 0
    for i in range(1, n_images + 1):
        w, h = int(rng.randint(320, 641)), int(rng.randint(240, 481))
        cv2.imwrite(os.path.join(root, image_set, "%012d.jpg" % i),
                    rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
        images.append(dict(id=i, width=w, height=h,
                           file_name="%012d.jpg" % i))
        for _ in range(rng.randint(1, 7)):
            bw, bh = rng.uniform(w / 6, w / 2), rng.uniform(h / 4, h * 0.8)
            x0, y0 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            kps = np.zeros((17, 3))
            on = rng.permutation(17)[:rng.randint(3, 18)]
            kps[on, 0] = x0 + rng.uniform(0, bw, len(on))
            kps[on, 1] = y0 + rng.uniform(0, bh, len(on))
            kps[on, 2] = rng.choice([1, 2], len(on))
            anns.append(dict(image_id=i, category_id=1, iscrowd=0,
                             keypoints=[float(v) for v in kps.reshape(-1)],
                             num_keypoints=len(on), bbox=[x0, y0, bw, bh],
                             area=bw * bh))
            n_people += 1
        crowd = np.zeros((h, w), np.uint8)
        cy, cx = rng.randint(0, h // 2), rng.randint(0, w // 2)
        crowd[cy:cy + h // 4, cx:cx + w // 5] = 1
        anns.append(dict(image_id=i, category_id=1, iscrowd=1, keypoints=[],
                         num_keypoints=0, bbox=[cx, cy, w // 5, h // 4],
                         area=float(crowd.sum()),
                         segmentation={"counts": rle_string(crowd),
                                       "size": [h, w]}))
        px, py = rng.uniform(w / 2, w - 40), rng.uniform(h / 2, h - 40)
        anns.append(dict(image_id=i, category_id=1, iscrowd=0,
                         keypoints=[0.0] * 51, num_keypoints=0,
                         bbox=[px, py, 30, 30], area=600.0,
                         segmentation=[[px, py, px + 30, py, px + 15,
                                        py + 30]]))
    for k, a in enumerate(anns, start=1):
        a["id"] = k
    with open(os.path.join(root, "annotations",
                           f"person_keypoints_{image_set}.json"), "w") as f:
        json.dump(dict(images=images, annotations=anns,
                       categories=[dict(id=1, name="person")]), f)
    return n_people


def bottomup_batch(cfg, dev, image_set: str = "val2017", n: int = 8):
    """The first eval batch of `image_set`: normalized NHWC images on
    `dev`, as `validate_bottomup` hands them to the eval step."""
    from advmix_tpu_torch.data import Loader, build_dataset
    from advmix_tpu_torch.ops.augment import IMAGENET_MEAN, IMAGENET_STD

    cfg = cfg.clone()
    cfg.defrost()
    cfg.DATASET.TEST_SET = image_set
    cfg.freeze()
    batches = iter(Loader(build_dataset(cfg, is_train=False), n))
    host = next(batches)
    batches.close()
    img = torch.from_numpy(host["image"]).to(dev).float()
    mean = torch.tensor(IMAGENET_MEAN, device=dev) * 255.0
    std = torch.tensor(IMAGENET_STD, device=dev) * 255.0
    return (img - mean) / std


def calibrate_bottomup_heads(model, cfg, image, pairs) -> dict:
    """Seeded weights stand in for a trained model, whose maps hold a few
    people per image; a random head's hold noise: most of the 17 x 30 peaks
    pass the 0.1 threshold, and random tags join no group, so nearly every
    detection seeds one. Three times (the heatmaps of head 0 feed the
    deconv module, so one shift moves head 1 again): shift the heatmap
    channels' biases of both heads so that each joint's maps hold
    BU_PEAKS_PER_MAP peaks above 0.1 on average after the 3x3 NMS, and
    scale the tag
    channels to a spread of BU_TAG_SPREAD. Returns the peaks above 0.1 per
    map and the tag spread of the result."""
    from advmix_tpu_torch.engine.steps import bottomup_infer_fn

    j = cfg.MODEL.NUM_JOINTS
    head0, head1 = model.final_layers[0], model.final_layers[1]
    infer = bottomup_infer_fn(model, cfg, pairs,
                              scales=tuple(cfg.TEST.SCALE_FACTOR))
    for _ in range(3):
        _, tags, peaks = infer(image)
        b = peaks["val"].shape[0]
        vals = peaks["val"].transpose(0, 1).reshape(j, -1).sort(
            dim=1, descending=True).values  # (J, B * k)
        delta = 0.1 - vals[:, BU_PEAKS_PER_MAP * b].to(head1.bias.dtype)
        scale = BU_TAG_SPREAD / float(tags.std())
        with torch.no_grad():
            head0.bias[:j] += delta
            head1.bias += delta
            head0.weight[j:] *= scale
            head0.bias[j:] *= scale
    _, tags, peaks = infer(image)
    return dict(peaks=float((peaks["val"] > 0.1).sum(-1).float().mean()),
                tag_std=float(tags.std()))


def dense_grouping(model, cfg, image, pairs, n_refine: int = 4) -> dict:
    """What the maps of the heads before `calibrate_bottomup_heads` cost
    the host grouping of one image (nothing caps the groups): the groups
    and seconds of `group_peaks`, and the seconds of `refine_group` for the
    first `n_refine` groups (each scans the whole map per missing joint;
    the parse refines every group)."""
    from advmix_tpu_torch.engine.steps import bottomup_infer_fn
    from advmix_tpu_torch.evaluation.grouping import group_peaks, \
        refine_group

    infer = bottomup_infer_fn(model, cfg, pairs,
                              scales=tuple(cfg.TEST.SCALE_FACTOR))
    heat, tags, peaks = infer(image[:1])
    heat = heat[0].cpu().numpy().transpose(1, 2, 0)
    tags = np.moveaxis(tags[0].cpu().numpy(), 0, 2)
    pk = {k: v[0].cpu().numpy() for k, v in peaks.items()}
    t0 = time.perf_counter()
    people = group_peaks(pk)
    t1 = time.perf_counter()
    for p in people[:n_refine]:
        refine_group(p, heat, tags)
    t2 = time.perf_counter()
    return dict(groups=len(people), group_s=t1 - t0,
                refine_s=(t2 - t1) / max(1, min(n_refine, len(people))),
                above=int((pk["val"] > 0.1).sum()))


def bottomup_infer_card_vs_cpu(model, cfg, image, pairs, dev) -> dict:
    """`bottomup_infer_fn` (flip test, TEST.SCALE_FACTOR of `cfg`) of the
    same weights in float64 on the card and on the CPU, on the same NHWC
    images. Returns max |diff| over max |CPU| of the heatmaps, the tags
    and the values of the peaks above 0.1, whether those peaks sit at the
    same pixels, and their number."""
    from advmix_tpu_torch.engine.steps import bottomup_infer_fn

    out = {}
    for key, where in (("cpu", torch.device("cpu")), ("card", dev)):
        m = copy.deepcopy(model).to(where).double().eval()
        heat, tags, peaks = bottomup_infer_fn(
            m, cfg, pairs, scales=tuple(cfg.TEST.SCALE_FACTOR))(
            image.to(where).double())
        out[key] = (heat.cpu(), tags.cpu(), {k: v.cpu() for k, v in
                                            peaks.items()})
        del m
    (h0, t0, p0), (h1, t1, p1) = out["cpu"], out["card"]
    above = p0["val"] > 0.1
    same = bool(torch.equal(above, p1["val"] > 0.1)
                and torch.equal(p0["x"][above], p1["x"][above])
                and torch.equal(p0["y"][above], p1["y"][above]))

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    return dict(heat=rel(h1, h0), tags=rel(t1, t0),
                peak_val=rel(p1["val"][above], p0["val"][above]),
                same_pixels=same, n_above=int(above.sum()),
                shape=tuple(h0.shape))


def bottomup_step_card_vs_cpu(cfg, start_path: str, dev,
                              batch_size: int = 2) -> dict:
    """One float64 `make_bottomup_advmix_step` (SGD) at full width and a
    BU_CHECK_SIZE input on the card and on the CPU, from the same state and
    the same views, 10 people per image, a valid mask of blocks. Returns
    both sides' metrics and, for D and G, max |diff| of the parameters
    after the step over max |update|."""
    from advmix_tpu_torch.engine.state import create_advmix_state
    from advmix_tpu_torch.engine.steps import make_bottomup_advmix_step
    from advmix_tpu_torch.models import (get_generator, get_pose_net,
                                         load_model_file)

    cfg = cfg.clone()
    cfg.defrost()
    cfg.TRAIN.OPTIMIZER = "sgd"
    cfg.TRAIN.LR = 0.01
    cfg.TRAIN.DTYPE = "float32"
    cfg.MODEL.IMAGE_SIZE = [BU_CHECK_SIZE, BU_CHECK_SIZE]
    cfg.MODEL.HEATMAP_SIZE = [BU_CHECK_SIZE // 4, BU_CHECK_SIZE // 4]
    cfg.freeze()
    rng = np.random.RandomState(SEED + 40)
    s = BU_CHECK_SIZE
    mask = np.ones((batch_size, s, s))
    mask[:, s // 4: s // 2, s // 8: s // 2] = 0
    batch = dict(
        views=torch.from_numpy(rng.randn(batch_size, 9, s, s)),
        joints=torch.from_numpy(rng.uniform(0, s - 2, (batch_size, 10, 17,
                                                       2))),
        joints_vis=torch.ones(batch_size, 10, 17, dtype=torch.float64),
        mask=torch.from_numpy(mask))
    after = {}
    for key, where in (("cpu", torch.device("cpu")), ("card", dev)):
        model = get_pose_net(cfg)
        load_model_file(model, start_path)
        g = get_generator()
        with torch.no_grad():  # G's N(0, 0.001) init gives ~0 logits
            for p_ in g.parameters():
                p_.mul_(30.0)
        model, g = model.double(), g.double()
        start = {"d": {k: v.clone() for k, v in model.state_dict().items()},
                 "g": {k: v.clone() for k, v in g.state_dict().items()}}
        state = create_advmix_state(cfg, model, g, where, torch.float64)
        step = make_bottomup_advmix_step(state, cfg, alpha=ALPHA,
                                         adv_loss_weight=ADV_W)
        metrics = step({k: v.to(where) for k, v in batch.items()})
        after[key] = dict(
            d={k: v.cpu() for k, v in state.model_d.state_dict().items()},
            g={k: v.cpu() for k, v in state.model_g.state_dict().items()},
            m={k: float(v) for k, v in metrics.items()})
        del state, step, model, g
    out = dict(cpu=after["cpu"]["m"], card=after["card"]["m"])
    for net in ("d", "g"):
        moved = diff = 0.0
        for k, ref in after["cpu"][net].items():
            if ref.is_floating_point():
                moved = max(moved, float((ref - start[net][k]).abs().max()))
                diff = max(diff, float((after["card"][net][k] - ref)
                                       .abs().max()))
        out[net] = diff / moved
    return out


def bottomup_phase(dev, tmp: str, kernel_fns) -> dict:
    """Phase 12. Returns the kernels' launches on each bottom-up path."""
    from advmix_tpu_torch.config import get_default_config

    torch.cuda.empty_cache()
    root = os.path.join(tmp, "bottomup")
    rng = np.random.RandomState(SEED + 50)
    people = {s: write_bottomup_coco(root, s, n, rng)
              for s, n in BU_SETS.items()}
    cfg = get_default_config()
    cfg.merge_from_file(HIGHER_CFG)
    cfg.DATASET.ROOT = root
    cfg.freeze()
    pairs = [[1, 2], [3, 4], [5, 6], [7, 8], [9, 10], [11, 12], [13, 14],
             [15, 16]]
    log(f"[bottomup] {os.path.relpath(HIGHER_CFG, HERE)}: synthetic COCO "
        f"sets (images, people): " + ", ".join(
            f"{s} ({BU_SETS[s]}, {people[s]})" for s in BU_SETS))

    # seeded weights, BN calibrated, heads calibrated
    t0 = time.perf_counter()
    model = random_model(cfg, dev)
    image = bottomup_batch(cfg, dev)
    dense = dense_grouping(model, cfg, image, pairs)
    model_raw = copy.deepcopy(model)
    heads = calibrate_bottomup_heads(model, cfg, image, pairs)
    start_path = os.path.join(tmp, "bu_start.pth")
    torch.save(model.state_dict(), start_path)
    # the multi-scale pass averages in the maps of 256 and 1024 inputs,
    # which the random trunk answers otherwise: its own calibration
    cfg_ms = cfg.clone()
    cfg_ms.defrost()
    cfg_ms.TEST.SCALE_FACTOR = [0.5, 1, 2]
    cfg_ms.freeze()
    model_ms = copy.deepcopy(model_raw)
    heads_ms = calibrate_bottomup_heads(model_ms, cfg_ms, image, pairs)
    start_ms = os.path.join(tmp, "bu_start_ms.pth")
    torch.save(model_ms.state_dict(), start_ms)
    del model, model_ms, image
    n_params = sum(p.numel() for p in model_raw.parameters())
    log(f"[bottomup] HigherHRNet-W32 ({n_params} params), seeded He weights "
        f"with calibrated BN: one image from the raw heads' maps (flip "
        f"test): {dense['above']} of 17 x 30 peaks above 0.1, group_peaks "
        f"{dense['groups']} groups in {dense['group_s']:.3f} s, "
        f"refine_group {dense['refine_s']:.3f} s per group (the parse "
        f"refines all {dense['groups']}: not run); heads calibrated: "
        f"{heads['peaks']:.2f} peaks above 0.1 per map, tag spread "
        f"{heads['tag_std']:.3f}; for [0.5, 1, 2]: {heads_ms['peaks']:.2f}"
        f", {heads_ms['tag_std']:.3f} ({time.perf_counter() - t0:.1f} s)")

    out = {"bottomup_eval": bottomup_eval_paths(
        dev, tmp, root, {"[1]": start_path, "[0.5, 1, 2]": start_ms},
        kernel_fns)}
    bottomup_card_vs_cpu(model_raw, cfg, pairs, dev, start_path)
    del model_raw
    torch.cuda.empty_cache()
    out["bottomup_train"] = bottomup_train_paths(dev, tmp, root, start_path,
                                                 kernel_fns)
    out["bottomup_sweep"] = bottomup_sweep_path(dev, tmp, root, start_path,
                                                kernel_fns)
    return out


@contextlib.contextmanager
def bottomup_stats():
    """Yields a dict that `validate_bottomup`'s timings and counts fill
    while the block runs (the entry points call it through the module)."""
    import advmix_tpu_torch.engine.trainer as trainer_mod

    stats: dict = {}
    real = trainer_mod.validate_bottomup

    def with_stats(*a, **k):
        return real(*a, stats=stats, **k)

    trainer_mod.validate_bottomup = with_stats
    try:
        yield stats
    finally:
        trainer_mod.validate_bottomup = real


def run_bottomup_validate(argv, kernel_fns) -> dict:
    """`tools/validate.main(argv)` with `validate_bottomup`'s timings
    captured. Returns the score, the timings, the launches, the wall
    seconds and the peak device memory."""
    from advmix_tpu_torch.tools import validate as validate_tool

    for fn in kernel_fns:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with bottomup_stats() as stats:
        names, ap = validate_tool.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not (np.isfinite(ap) and 0.0 <= ap <= 1.0) or "AP" not in names:
        raise AssertionError(f"bottom-up AP {ap} is not a valid score")
    if stats.get("images") != BU_SETS["val2017"] or not stats["groups"]:
        raise AssertionError(f"validate_bottomup grouped {stats}")
    return dict(ap=ap, stats=stats, wall=wall,
                launches=launch_counts(kernel_fns),
                peak=torch.cuda.max_memory_allocated() / 2**30)


def bottomup_eval_paths(dev, tmp: str, root: str, starts: dict,
                        kernel_fns) -> dict:
    """12a: the YAML's eval through `tools/validate.main` (flip test, bf16,
    batch 8), at TEST.SCALE_FACTOR [1] and [0.5, 1, 2] (`starts`: the
    weights for each), and the OCHuman YAML through the alias; then the
    device infer of one batch timed and profiled at each scale setting.
    Returns the launches (all 0)."""
    from advmix_tpu_torch.config import get_default_config
    from advmix_tpu_torch.engine.steps import make_bottomup_eval_step
    from advmix_tpu_torch.models import get_pose_net, load_model_file
    from advmix_tpu_torch.models.layers import set_compute_dtype

    total = {fn.__name__: 0 for fn in kernel_fns}
    for rel, scales in ((HIGHER_CFG, "[1]"), (HIGHER_CFG, "[0.5, 1, 2]"),
                        (OCHUMAN_CFG, "[1]")):
        name = os.path.basename(os.path.dirname(os.path.dirname(rel)))
        argv = ["--cfg", rel, "--device", str(dev), "--modelDir",
                os.path.join(tmp, "bu_val_out"), "--logDir",
                os.path.join(tmp, "bu_val_log"), "DATASET.ROOT", root,
                "TEST.MODEL_FILE", starts[scales], "TEST.SCALE_FACTOR",
                scales]
        r = run_bottomup_validate(argv, kernel_fns)
        st = r["stats"]
        for k in total:
            total[k] += r["launches"][k]
        log(f"[bottomup] tools/validate.main {name} TEST.SCALE_FACTOR "
            f"{scales}: {r['wall']:.2f} s (cuDNN autotuning included) over "
            f"{st['images']} images; step to read-back {st['device_s']:.3f} "
            f"s, host grouping {st['group_s'] / st['images']:.4f} s/image, "
            f"{st['groups'] / st['images']:.2f} groups/image, COCO eval "
            f"{st['eval_s']:.3f} s; AP {r['ap']:.4f} (seeded weights); peak "
            f"device memory {r['peak']:.2f} GiB; launches {r['launches']}")
        if rel == OCHUMAN_CFG:
            continue
        cfg = get_default_config()
        cfg.merge_from_file(rel)
        cfg.DATASET.ROOT = root
        cfg.TEST.SCALE_FACTOR = json.loads(scales)
        cfg.freeze()
        model = get_pose_net(cfg)
        load_model_file(model, starts[scales])
        model = set_compute_dtype(model.to(dev).eval(), torch.bfloat16)
        step = make_bottomup_eval_step(model, cfg, [[1, 2], [3, 4], [5, 6],
                                                    [7, 8], [9, 10], [11, 12],
                                                    [13, 14], [15, 16]],
                                       scales=tuple(cfg.TEST.SCALE_FACTOR))
        batch = {"image": bottomup_batch(cfg, dev)}
        torch.cuda.reset_peak_memory_stats()
        ms = wall_ms(lambda: step(batch), iters=5)
        prof = profile_by_family(lambda: step(batch), steps=2)
        log(f"[bottomup] eval step (bf16, flip, scales {scales}) at batch "
            f"8: {ms:.3f} ms/batch, {8 / ms * 1e3:.1f} img/s; profile of 2 "
            f"steps: wall {prof['wall_ms']:.3f} ms/step, device busy "
            f"{prof['busy_ms']:.3f} ms ({100 * prof['busy_share']:.1f}%), "
            f"{prof['kernels']} kernels per step; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        log_families("bottomup", prof)
        del model, step, batch
        torch.cuda.empty_cache()
    if any(total.values()):
        raise AssertionError(f"a kernel launched on the bottom-up eval {total}")
    return total


def bottomup_card_vs_cpu(model, cfg, pairs, dev, start_path: str) -> None:
    """12b: the float64 infer and the float64 AdvMix step, card against
    CPU, at a BU_CHECK_SIZE input (the CPU's float64 convolutions are the
    cost). The infer runs the raw heads (hundreds of peaks above 0.1 to
    compare) on 2 images at one scale and 1 at [0.5, 1, 2]."""
    c = cfg.clone()
    c.defrost()
    c.MODEL.IMAGE_SIZE = [BU_CHECK_SIZE, BU_CHECK_SIZE]
    c.MODEL.HEATMAP_SIZE = [BU_CHECK_SIZE // 4, BU_CHECK_SIZE // 4]
    c.freeze()
    image = bottomup_batch(c, dev, n=2)
    for scales, n in (((1.0,), 2), ((0.5, 1.0, 2.0), 1)):
        c.defrost()
        c.TEST.SCALE_FACTOR = list(scales)
        c.freeze()
        t0 = time.perf_counter()
        r = bottomup_infer_card_vs_cpu(model, c, image[:n], pairs, dev)
        ok = (r["heat"] < 1e-12 and r["tags"] < 1e-12 and r["peak_val"] < 1e-12
              and r["same_pixels"] and r["n_above"] > 0)
        log(f"[bottomup] float64 infer, card vs CPU, {n} image(s) at "
            f"{BU_CHECK_SIZE}x{BU_CHECK_SIZE}, scales {list(scales)}: max "
            f"|diff| / max |CPU| heat {r['heat']:.3g}, tags {r['tags']:.3g}, "
            f"the {r['n_above']} peaks above 0.1 {r['peak_val']:.3g}, same "
            f"pixels {r['same_pixels']} (limit 1e-12; "
            f"{time.perf_counter() - t0:.1f} s)")
        if not ok:
            raise AssertionError(f"bottom-up infer card vs CPU: {r}")
    t0 = time.perf_counter()
    r = bottomup_step_card_vs_cpu(cfg, start_path, dev)
    gaps = {k: abs(r["card"][k] - r["cpu"][k]) / max(1.0, abs(r["cpu"][k]))
            for k in ("loss_d", "loss_g")}
    log(f"[bottomup] float64 AdvMix step, card vs CPU, batch 2 at "
        f"{BU_CHECK_SIZE}x{BU_CHECK_SIZE}: loss_d {r['card']['loss_d']:.9f} / "
        f"{r['cpu']['loss_d']:.9f}, loss_g {r['card']['loss_g']:.9f} / "
        f"{r['cpu']['loss_g']:.9f}; parameters after the step, max |diff| "
        f"/ max |update|: D {r['d']:.3g}, G {r['g']:.3g} (limit 1e-6; "
        f"{time.perf_counter() - t0:.1f} s)")
    if max(gaps.values()) > 1e-6 or r["d"] > 1e-6 or r["g"] > 1e-6:
        raise AssertionError(f"bottom-up AdvMix step card vs CPU: {r}")


def bottomup_train_paths(dev, tmp: str, root: str, start_path: str,
                         kernel_fns) -> dict:
    """12c: `tools/train.main --advmix --sample_times 3` (3 iterations of
    batch 12, validate, checkpoint) and a plain epoch of 2 iterations; the
    AdvMix iteration timed and profiled at batch 12 (`tools/bench`), and
    the bench CLI run. Returns the launches (all 0)."""
    from advmix_tpu_torch.config import get_default_config
    from advmix_tpu_torch.tools import bench as bench_tool
    from advmix_tpu_torch.tools import train as train_tool

    total = {fn.__name__: 0 for fn in kernel_fns}
    for mode, n_iter in (("advmix", 3), ("plain", 2)):
        flags = (["--advmix", "--sample_times", "3"] if mode == "advmix"
                 else [])
        opts = ["DATASET.TEST_SET", "val1"] + (
            [] if mode == "advmix" else ["DATASET.TRAIN_SET", "train24"])
        argv = ["--cfg", HIGHER_CFG, "--device", str(dev), "--load_from_D",
                start_path, "--modelDir", os.path.join(tmp, f"bu_{mode}"),
                "--logDir", os.path.join(tmp, f"bu_{mode}_log"), *flags,
                "DATASET.ROOT", root, "TRAIN.END_EPOCH", "1", "PRINT_FREQ",
                "1", *opts]
        for fn in kernel_fns:
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with bottomup_stats() as stats:
            result = train_tool.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts(kernel_fns)
        for k in total:
            total[k] += launches[k]
        hist = result["history"]
        key = "loss_d" if mode == "advmix" else "loss"
        if len(hist) != 1 or len(hist[0]) != n_iter:
            raise AssertionError(f"bottom-up {mode}: trained "
                                 f"{[len(h) for h in hist]} iterations")
        for i, m in enumerate(hist[0]):
            if not (np.isfinite(m[key]) and m[key] > 0) or (
                    mode == "advmix" and not m["loss_g"] < 0):
                raise AssertionError(f"bottom-up {mode} iteration {i}: {m}")
        if not (np.isfinite(result["perf"]) and os.path.isfile(
                result["final_state"])):
            raise AssertionError(f"bottom-up {mode}: AP {result['perf']}, "
                                 "no final state")
        losses = ", ".join(f"{m[key]:.6f}" for m in hist[0])
        log(f"[bottomup] tools/train.main {mode}: 1 epoch of {n_iter} "
            f"iterations of batch 12 + validate_bottomup() on "
            f"{stats['images']} images: {wall:.2f} s (cuDNN autotuning "
            f"included), peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {key} "
            f"{losses}; validation: {stats['groups'] / stats['images']:.1f} "
            f"groups/image, host grouping "
            f"{stats['group_s'] / stats['images']:.3f} s/image; AP "
            f"{result['perf']:.4f}; launches {launches}")
        del result
        torch.cuda.empty_cache()
    if any(total.values()):
        raise AssertionError(f"a kernel launched on bottom-up training {total}")

    cfg = get_default_config()
    cfg.merge_from_file(HIGHER_CFG)
    cfg.freeze()
    t = bench_tool.time_advmix(cfg, dev, 12, torch.bfloat16, iters=3,
                               inspect=profile_by_family)
    prof = t["inspect"]
    log(f"[bottomup] AdvMix bf16 batch 12 at 512x512, 10 people per image "
        f"(tools/bench.time_advmix): view synthesis {t['views_ms']:.3f} ms, "
        f"step {t['step_ms']:.3f} ms, both {t['both_ms']:.3f} ms/iteration "
        f"= {t['img_per_s']:.1f} img/s; peak device memory "
        f"{t['peak_gib']:.2f} GiB; profile of 2 iterations: device busy "
        f"{prof['busy_ms']:.3f} ms ({100 * prof['busy_share']:.1f}%), "
        f"{prof['kernels']} kernels per iteration")
    log_families("bottomup", prof)
    torch.cuda.empty_cache()
    import io

    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):  # its JSON line, into the log
        res = bench_tool.main(["--cfg", HIGHER_CFG, "--batch", "12",
                               "--iters", "3"])
    if res["batch"] != 12 or not np.isfinite(res["loss_d"]):
        raise AssertionError(f"tools.bench bottom-up: {res}")
    log(f"[bottomup] tools.bench --cfg {os.path.relpath(HIGHER_CFG, HERE)} "
        f"--batch 12 --iters 3 printed: {printed.getvalue().strip()}")
    torch.cuda.empty_cache()
    return total


def bottomup_sweep_path(dev, tmp: str, root: str, start_path: str,
                        kernel_fns) -> dict:
    """12d: `tools/test_corruption.main --on_the_fly` over one batch of 8
    images: clean + BU_SWEEP x 5 severities. Returns the launches (0)."""
    import csv

    argv = ["--cfg", HIGHER_CFG, "--on_the_fly", "--device", str(dev),
            "--distortions", ",".join(BU_SWEEP), "--modelDir",
            os.path.join(tmp, "bu_sweep_out"), "--logDir",
            os.path.join(tmp, "bu_sweep_log"), "DATASET.ROOT", root,
            "DATASET.TEST_SET", "val8", "TEST.MODEL_FILE", start_path]
    n_pass = 1 + 5 * len(BU_SWEEP)
    sw = run_sweep(argv, None, kernel_fns, n_pass=n_pass)
    with open(sw["result"]["csv"]) as f:
        row = next(csv.DictReader(f))
    for k in ("clean_mAP", "mean_corrupted_mAP", "rAP", *BU_SWEEP):
        if not np.isfinite(float(row[k])):
            raise AssertionError(f"bottom-up CSV {k} = {row[k]}")
    if any(sw["launches"].values()):
        raise AssertionError(f"a kernel launched on the sweep {sw['launches']}")
    log(f"[bottomup] tools/test_corruption.main --on_the_fly --distortions "
        f"{','.join(BU_SWEEP)}: {n_pass} passes over {BU_SETS['val8']} "
        f"images (one batch) in {sw['wall']:.2f} s; CSV clean_mAP "
        f"{row['clean_mAP']} mean_corrupted_mAP {row['mean_corrupted_mAP']} "
        f"rAP {row['rAP']} (seeded weights); launches {sw['launches']}")
    log_sweep_times("bottomup", sw)
    return sw["launches"]


def card_matches_cpu(name: str, model, dev, image_size) -> None:
    """The model on the card against the same model on the CPU on one
    seeded random image, leaving it f32 on the card. In float64 the two
    compute the same function: within 1e-9 of the output's range. In f32
    (TF32 off) their gap grows with depth through the random weights (a
    ResNet-152 was 3e-3 of the range apart on an NVIDIA H100 80GB HBM3 at
    700 W, with the CPU itself 2e-3 from f64), so the card's f32 output is
    held to the f64 one no further than 10x the CPU's own f32 output is
    (or 2e-3 of the range, where the CPU's is closer still): cuDNN picks
    other algorithms than the CPU, while TF32's 10-bit mantissa would round
    each product 2^13 times coarser than f32's 23 bits."""
    import copy

    w, h = image_size
    x = torch.from_numpy(np.random.RandomState(3).randn(
        1, 3, h, w).astype(np.float32))
    cpu = copy.deepcopy(model).cpu()
    model.to(dev)
    with torch.no_grad():
        ref64 = cpu.double()(x.double())
        card64 = model.double()(x.double().to(dev)).cpu()
        cpu32 = cpu.float()(x)
        card32 = model.float()(x.to(dev)).cpu()
    del cpu
    rng = float(ref64.abs().max())
    e64 = float((card64 - ref64).abs().max()) / rng
    e_card = float((card32.double() - ref64).abs().max()) / rng
    e_cpu = float((cpu32.double() - ref64).abs().max()) / rng
    gap = float((card32 - cpu32).abs().max()) / rng
    n_params = sum(p.numel() for p in model.parameters())
    if not (torch.isfinite(card32).all() and e64 < 1e-9
            and e_card <= max(10 * e_cpu, 2e-3)):
        raise AssertionError(
            f"{name} on the card vs the CPU, over max |f64 output| {rng:.3g}:"
            f" f64 {e64:.3g} (limit 1e-9); f32 card {e_card:.3g} from the "
            f"f64 output, CPU {e_cpu:.3g} (limit 10x the CPU's or 2e-3)")
    log(f"[families] {name} ({n_params} params) on the card vs the CPU, "
        f"max |diff| / max |f64 output| ({rng:.3g}): f64 {e64:.3g} (limit "
        f"1e-9); f32 card vs CPU {gap:.3g}, card vs f64 {e_card:.3g}, CPU "
        f"vs f64 {e_cpu:.3g} (limit 10x the CPU's or 2e-3; TF32 off)")


def synthetic_coco_class():
    """`COCODataset` with seeded random pixels for its records' images."""
    from advmix_tpu_torch.data import COCODataset
    from advmix_tpu_torch.ops.transforms import affine_transform, \
        get_affine_transform

    class SyntheticCropCOCO(COCODataset):
        """The COCO records, with seeded random uint8 pixels in place of
        decoded JPEGs (the records have no images): whole crops on the eval
        path, and 640x480 source images on the training path, which
        `get_raw_sample` pads into the warp bucket."""

        eval_seconds = 0.0

        def _read_image(self, path):
            seed = int(os.path.basename(path).split(".")[0])
            return np.random.RandomState(seed).randint(
                0, 256, (480, 640, 3), dtype=np.uint8)

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

    return SyntheticCropCOCO


def main() -> None:
    # ---- 1. card ----------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, HERE)
    from advmix_tpu_torch.config import get_default_config
    from advmix_tpu_torch.data import Loader
    from advmix_tpu_torch.engine.steps import make_eval_step
    from advmix_tpu_torch.engine.trainer import (make_eval_preprocessor,
                                                 validate)
    from advmix_tpu_torch.models.layers import set_compute_dtype
    from advmix_tpu_torch.native import get_lib
    from advmix_tpu_torch.ops.cuda import build as kbuild
    from advmix_tpu_torch.ops.cuda.decode_kernel import (
        decode_heatmaps, decode_heatmaps_plain)
    from advmix_tpu_torch.ops.cuda.oks_kernel import (oks_matrix,
                                                      oks_matrix_batched)
    from advmix_tpu_torch.ops.transforms import transform_preds_batch

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

    SyntheticCropCOCO = synthetic_coco_class()
    dataset = SyntheticCropCOCO(cfg, is_train=False)
    loader = Loader(dataset, cfg.TEST.BATCH_SIZE_PER_GPU)
    log(f"[path] {os.path.relpath(CFG, HERE)}: {len(dataset)} people in "
        f"{len(got_counts)} images, {len(loader)} batches of "
        f"{cfg.TEST.BATCH_SIZE_PER_GPU}")

    model = random_model(cfg, torch.device("cpu"))
    n_params = sum(p.numel() for p in model.parameters())
    # the training phase starts D and the teacher from these weights
    start_path = os.path.join(tmp, "d_start.pth")
    torch.save(model.state_dict(), start_path)

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
    batch = first_batch(loader, prep, dev)
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

    # ---- 5. AdvMix training through the train entry point -----------------
    del model, eval_step, batch, heat
    torch.cuda.empty_cache()
    kernel_fns = (decode_heatmaps, oks_matrix_batched, oks_matrix)
    paths = {}  # launches on each later path, by its key in the JSON line
    paths["train"] = train_phase(dev, tmp, start_path, SyntheticCropCOCO,
                                 kernel_fns)

    # ---- 6. corruptions -----------------------------------------------------
    corruption_phase(dev)

    # ---- 7. the robustness sweep through its entry point ------------------
    paths["sweep"] = sweep_phase(dev, tmp, start_path, SyntheticCropCOCO,
                                 kernel_fns)

    # ---- 8. --random_corruption training ----------------------------------
    paths["train_random_corruption"] = random_corruption_train_phase(
        dev, tmp, start_path, SyntheticCropCOCO, kernel_fns)

    # ---- 9. the other COCO families --------------------------------------
    paths["families"] = families_phase(dev, tmp, SyntheticCropCOCO,
                                       kernel_fns)

    # ---- 10. MPII: training, PCKh, the MPII-C sweep, decode at 16x64x64 ---
    mpii = mpii_phase(dev, tmp, kernel_fns, rng, flush)
    paths["mpii_train"], paths["mpii_sweep"] = mpii["train"], mpii["sweep"]
    report["decode_heatmaps"]["mpii_shape"] = mpii["decode"]

    # ---- 11. TEST.SOFT_ARGMAX ---------------------------------------------
    paths["soft_argmax"] = soft_argmax_phase(
        dev, tmp, start_path, SyntheticCropCOCO, kernel_fns)["launches"]

    # ---- 12. bottom-up HigherHRNet-W32 512x512 ----------------------------
    paths.update(bottomup_phase(dev, tmp, kernel_fns))

    kernels = []
    for k in ("decode_heatmaps", "oks_matrix_batched", "oks_matrix"):
        r = dict(report[k])
        # the eval path's count; each later path's own beside it
        r["launches"] = launches[k]
        for path, counts in paths.items():
            r[f"launches_{path}"] = counts[k]
        kernels.append(r)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
