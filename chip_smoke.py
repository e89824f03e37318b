#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
1. card: require CUDA, print the card's name and power limit, turn TF32
   off for the f32 comparisons;
2. build: compile the port's CUDA kernels (advmix_tpu_torch/csrc) with
   nvcc for sm_90a and print the build time;
3. kernels: hold each kernel against its plain PyTorch version on the card
   (decode bit-equal; OKS within rtol 1e-5, atol 1e-6; NMS keep lists equal
   to the numpy oracle) and time both with CUDA events;
4. full path: experiments/coco/hrnet/w32_256x192_advmix.yaml at full
   width (seeded random weights, bf16, flip test, batch 128) through the
   port's validate() on a synthetic COCO val set, counting the kernels'
   launches on that run;
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


def time_ms(fn, iters: int = 20, flush: torch.Tensor | None = None) -> float:
    """Mean device ms of one fn() call, by CUDA events around `iters` calls
    after 3 warm-ups. A sleep kernel holds the stream while the host
    enqueues the calls, so Python's launch overhead is not timed. With
    `flush`, the 50 MB L2 cache is overwritten before each call and the
    flushes' own time, measured alone, is subtracted."""
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
                flush.zero_()
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


def profile_step(fn, steps: int = 3) -> None:
    """Device time of `steps` calls by kernel family (torch.profiler),
    and the device's busy share of the window's wall time."""
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
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    log(f"[profile] {steps} eval steps: wall {wall_us / 1e3:.3f} ms, device "
        f"busy {busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}%), "
        f"{len(kernels) // steps} kernels per step")
    by_name: dict = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"[profile]   {t / steps / 1e3:8.3f} ms/step  {n // steps:5d} "
            f"launches/step  {name[:90]}")


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
    from advmix_tpu_torch.native import get_lib, greedy_from_matrix
    from advmix_tpu_torch.ops.cuda import build as kbuild
    from advmix_tpu_torch.ops.cuda.decode_kernel import (
        decode_heatmaps, decode_heatmaps_plain)
    from advmix_tpu_torch.ops.cuda.oks_kernel import (
        oks_matrix, oks_matrix_batched, oks_matrix_batched_plain)
    from advmix_tpu_torch.ops.nms import oks_nms_np
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
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    report = {}

    # ---- 3. kernels vs plain versions ------------------------------------
    hm = torch.from_numpy(decode_inputs(rng)).to(dev)
    err = 0.0
    for post in (True, False):
        ck, mk = decode_heatmaps(hm, post_process=post)
        cp, mp = decode_heatmaps_plain(hm, post_process=post)
        torch.cuda.synchronize()
        if not (torch.equal(ck, cp) and torch.equal(mk, mp)):
            bad = (ck != cp).any(-1).nonzero()[:5].tolist()
            raise AssertionError(f"decode(post={post}) differs from the "
                                 f"plain version at maps {bad}")
        fin = torch.isfinite(mp)  # -inf maps: inf - inf is NaN
        err = max(err, float((ck - cp).abs().max()),
                  float((mk - mp)[fin].abs().max()))
    log(f"[kernels] decode {tuple(hm.shape)}: bit-equal to the plain version "
        "(random, ties, bf16, zero, negative, -inf, border peaks)")
    b, j, h, w = hm.shape
    hm_main = torch.randn(b, j, h, w, device=dev)
    nb, fl = bound(b * j * h * w * 4 + b * j * 3 * 4, b * j * h * w)
    report["decode_heatmaps"] = dict(
        name="decode_heatmaps", route="cuda",
        source="advmix_tpu_torch/csrc/decode.cu",
        replaces="advmix_tpu/ops/pallas/decode_kernel.py:73",
        max_abs_err=err,
        ms=time_ms(lambda: decode_heatmaps(hm_main), flush=flush),
        plain_ms=time_ms(lambda: decode_heatmaps_plain(hm_main),
                         flush=flush),
        bound_ms=nb, bound_by=fl, library_ms=None)
    log(f"[kernels] decode {tuple(hm.shape)}: "
        f"{report['decode_heatmaps']['ms']:.4f} ms, plain "
        f"{report['decode_heatmaps']['plain_ms']:.4f} ms, bound "
        f"{nb * 1e3:.2f} us ({fl})")

    # the full path's shapes (phase 4's data): 47 images of 2..20 people
    # -> M=47 images padded to P=32, and one image of N=130 people
    n_img, n_big = 47, 130
    data_rng = np.random.RandomState(SEED + 1)
    counts = [int(c) for c in data_rng.randint(2, 21, n_img)]
    m_main, p_main = n_img, 1 << (max(counts) - 1).bit_length()

    def check_oks(kind, m, p):
        kpts, scores, areas = oks_inputs(rng, m, p)
        kt = torch.from_numpy(kpts).to(dev)
        at = torch.from_numpy(areas.astype(np.float32)).to(dev)
        if kind == "batched":
            got = oks_matrix_batched(kt, at)
        else:
            got = oks_matrix(kt[0], at[0])[None]
        want = oks_matrix_batched_plain(kt, at)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        e = float((got - want).abs().max())
        sims = got.cpu().numpy()
        for i in range(min(m, 4)):
            keep = greedy_from_matrix(sims[i], scores[i].astype(np.float32),
                                      0.9)
            ref = oks_nms_np(flat_kpts(kpts[i].astype(np.float64)),
                             scores[i], areas[i], 0.9)
            if keep != ref:
                raise AssertionError(f"oks {kind} M={m} P={p} image {i}: "
                                     f"keep {keep} != oks_nms_np {ref}")
        log(f"[kernels] oks {kind} M={m} P={p}: max |err| {e:.3g}, keep "
            "lists equal oks_nms_np")
        return e, kt, at

    errs = {"batched": 0.0, "single": 0.0}
    for p in (2, 16, 128):
        errs["batched"] = max(errs["batched"], check_oks("batched", 64, p)[0])
    e, kb, ab = check_oks("batched", m_main, p_main)
    errs["batched"] = max(errs["batched"], e)
    for n in (300, n_big):
        e, ks, as_ = check_oks("single", 1, n)
        errs["single"] = max(errs["single"], e)

    def oks_bound(m, p):
        return bound(m * p * j * 2 * 4 + m * p * 4 + j * 4 + m * p * p * 4,
                     m * p * p * (9 * j + 4))

    nb, fl = oks_bound(m_main, p_main)
    report["oks_matrix_batched"] = dict(
        name="oks_matrix_batched", route="cuda",
        source="advmix_tpu_torch/csrc/oks.cu",
        replaces="advmix_tpu/ops/pallas/oks_kernel.py:68",
        max_abs_err=errs["batched"],
        ms=time_ms(lambda: oks_matrix_batched(kb, ab)),
        plain_ms=time_ms(lambda: oks_matrix_batched_plain(kb, ab)),
        bound_ms=nb, bound_by=fl, library_ms=None)
    nb, fl = oks_bound(1, n_big)
    report["oks_matrix"] = dict(
        name="oks_matrix", route="cuda",
        source="advmix_tpu_torch/csrc/oks.cu",
        replaces="advmix_tpu/ops/pallas/oks_kernel.py:115",
        max_abs_err=errs["single"],
        ms=time_ms(lambda: oks_matrix(ks[0], as_[0])),
        plain_ms=time_ms(lambda: oks_matrix_batched_plain(ks, as_)),
        bound_ms=nb, bound_by=fl, library_ms=None)
    for k in ("oks_matrix_batched", "oks_matrix"):
        r = report[k]
        log(f"[kernels] {k}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms,"
            f" bound {r['bound_ms'] * 1e3:.3f} us ({r['bound_by']})")

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
    profile_step(lambda: eval_step(batch))

    kernels = []
    for k in ("decode_heatmaps", "oks_matrix_batched", "oks_matrix"):
        r = dict(report[k])
        r["launches"] = launches[k]
        kernels.append({key: r[key] for key in (
            "name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
