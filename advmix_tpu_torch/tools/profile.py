"""Step profiler: trace training or eval steps under torch.profiler and
print the card's time per step by kernel family and by program phase.

    python -m advmix_tpu_torch.tools.profile --cfg <yaml> \
        [--advmix --sample_times 3] [--profile_steps 5] [--trace_dir D] \
        [--per_kernel N] [--peak_gbs GBS | --peak_gbs hbm_peak.json] \
        [--device cpu] [--num_devices N] [KEY VALUE ...]
    python -m advmix_tpu_torch.tools.profile --cfg <yaml> --eval \
        [--corruption_type NAME --severity 0..4] [...]

Counterpart of `tools/profile.py`: one warm-up step, then `--profile_steps`
steps of the standard or the AdvMix step (top-down, or bottom-up for
MODEL.NAME pose_higher_hrnet, as the train entry point dispatches them) on
a seeded random batch of BATCH_SIZE_PER_GPU per rank, traced by
`utils/profiling.trace` into `<trace_dir>/trace.json`. `--eval` profiles
the top-down eval pass instead (`trainer.make_eval_preprocessor` and
`steps.make_eval_step`, as `tools/test_corruption` runs one pass of its
sweep) on seeded crops of TEST.BATCH_SIZE_PER_GPU, corrupted by
`--corruption_type` where one is given, at `--severity` (0-based, as
TEST.SEVERITY and the -C tree's directories count); it also prints the
corruption constants built a step (`advmix.count.const_build`: 0 while
the pass's constants stay cached). The "step profile" table gives device
ms and launches per step by kernel family (`utils/profiling.family_of`);
`--per_kernel N` adds the N costliest kernels (`analyze_kernels`). The "by
phase" table gives, per step, each of the program's `advmix.*` spans
(`utils/profiling.span`: the AdvMix or eval step's phases, the
preprocessors, the collectives) with its host ms, and the
device ms, idle ms and launches of the work launched inside it
(`analyze_phases`); `advmix.count.*` rows count events. A roofline column
needs the card's measured bandwidth: `--peak_gbs` takes a number or the
JSON line that `tools/hbm_peak.py` prints (its `measured_peak_gbs`), and
without it no roofline is printed. A CPU run (`--device cpu`) traces host
operators only, so its step table is empty and its phase table has host
ms alone. With several ranks, rank 0 profiles and prints.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import tempfile

import torch

from ..config import get_default_config, update_config
from ..engine import steps
from ..engine.state import create_advmix_state, create_pose_state
from ..data.datasets import COCODataset, MPIIDataset
from ..engine.trainer import make_bottomup_preprocessor, \
    make_eval_preprocessor, make_preprocessor
from ..models import get_generator, get_pose_net
from ..models.layers import set_compute_dtype
from ..parallel import dist as pdist
from ..utils.profiling import COUNT_PREFIX, PREFIX, family_of, phase_rows, \
    trace
from ._parse import parse_args, ranks

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core FLOP/s (the table's
# roofline takes the larger of the bytes' and the FLOPs' time)
H100_BF16_TFLOPS = 989.0


def _load_trace(trace_dir: str) -> dict:
    """The newest Chrome trace under `trace_dir`."""
    paths = sorted(glob.glob(os.path.join(trace_dir, "*.json")),
                   key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no trace under {trace_dir}")
    with open(paths[-1]) as f:
        return json.load(f)


_ITEMSIZE = {"float": 4, "c10::BFloat16": 2, "c10::Half": 2, "double": 8,
             "long int": 8, "int": 4, "unsigned char": 1, "bool": 1,
             "signed char": 1, "short int": 2}


def _op_bytes(args: dict) -> int:
    """Bytes of an operator's tensor inputs, each read once, from the
    trace's "Input Dims" and "Input type" (the trace records no outputs:
    a lower bound of the op's traffic)."""
    total = 0
    for dims, typ in zip(args.get("Input Dims", []),
                         args.get("Input type", [])):
        if isinstance(dims, list) and dims and all(
                isinstance(d, int) for d in dims):
            n = 1
            for d in dims:
                n *= d
            total += n * _ITEMSIZE.get(typ, 0)
    return total


def _charged_ops(events) -> dict:
    """{External id of an operator: (bytes, FLOPs) to charge to its
    kernels}. The operator that launches a kernel is often an inner one
    (aten::cudnn_convolution inside aten::conv2d): its nearest enclosing
    operator with a FLOP count (`with_flops`), itself included, is charged,
    with that operator's inputs as its bytes."""
    ops = sorted((e for e in events if e.get("ph") == "X"
                  and e.get("cat") == "cpu_op"),
                 key=lambda e: (e.get("tid"), e["ts"], -e["dur"]))
    parent, stack, tid = {}, [], None
    for i, e in enumerate(ops):
        if e.get("tid") != tid:
            stack, tid = [], e.get("tid")
        while stack and ops[stack[-1]]["ts"] + ops[stack[-1]]["dur"] \
                < e["ts"] + e["dur"]:
            stack.pop()
        parent[i] = stack[-1] if stack else None
        stack.append(i)
    out = {}
    for i, e in enumerate(ops):
        ext = e.get("args", {}).get("External id")
        if ext is None:
            continue
        j = i
        while j is not None and not ops[j].get("args", {}).get("flops"):
            j = parent[j]
        a = ops[i if j is None else j]["args"]
        out[ext] = (_op_bytes(a), float(a.get("flops", 0)),
                    i if j is None else j)
    return out


def analyze_kernels(trace_dir: str, n_steps: int,
                    peak_gbs: float | None = None,
                    peak_tflops: float = H100_BF16_TFLOPS) -> list:
    """Per kernel name, per step: device ms, GB and GFLOP of the operators
    that launched it (`_charged_ops`; each operator counted once, on its
    first kernel), the speed-of-light ms max(GB / peak_gbs, GFLOP /
    peak_tflops) when `peak_gbs` is given (else None), and launches.
    Rows (name, ms, GB, GFLOP, sol_ms, launches), costliest first."""
    events = _load_trace(trace_dir)["traceEvents"]
    ops = _charged_ops(events)
    agg = collections.defaultdict(lambda: [0.0, 0, 0.0, 0])
    charged = set()
    for e in sorted((e for e in events if e.get("ph") == "X"
                     and e.get("cat") == "kernel"),
                    key=lambda e: e.get("ts", 0)):
        row = agg[e.get("name", "?")]
        row[0] += e["dur"]
        row[3] += 1
        op = ops.get(e.get("args", {}).get("External id"))
        if op is not None and op[2] not in charged:
            charged.add(op[2])
            row[1] += op[0]
            row[2] += op[1]
    rows = []
    for name, (dur, byt, fl, cnt) in agg.items():
        gb = byt / n_steps / 1e9
        gfl = fl / n_steps / 1e9
        sol = (None if peak_gbs is None else
               max(gb / peak_gbs * 1e3, gfl / (peak_tflops * 1e3) * 1e3))
        rows.append((name, dur / n_steps / 1e3, gb, gfl, sol,
                     cnt // max(n_steps, 1)))
    rows.sort(key=lambda r: -r[1])
    return rows


def analyze_trace(trace_dir: str, n_steps: int) -> list:
    """Device ms and launches per step by kernel family, largest first."""
    t = collections.Counter()
    n = collections.Counter()
    for e in _load_trace(trace_dir)["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            fam = family_of(e.get("name", ""))
            t[fam] += e["dur"]
            n[fam] += 1
    if not t:
        print("(no device kernels in the trace: a CPU run traces host "
              "operators only)")
    rows = [(f, t[f] / n_steps / 1e3, n[f] / n_steps) for f in t]
    rows.sort(key=lambda r: -r[1])
    return rows


_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def analyze_phases(trace_dir: str, n_steps: int) -> list:
    """`utils/profiling.phase_rows` of the program's `advmix.*` spans in
    the Chrome trace: per step, each span's calls, host ms, device ms and
    idle ms (of the operations launched inside it) and device operations.
    A device operation's launch is its runtime call (the trace's
    "correlation"), else its operator's start ("External id"). Without
    device operations (a CPU run) the device columns are None."""
    spans, launch_at, op_at, device = [], {}, {}, []
    for e in _load_trace(trace_dir)["traceEvents"]:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat"), e.get("args", {})
        if cat == "user_annotation" and e.get("name", "").startswith(PREFIX):
            spans.append((e["name"], e["ts"], e["ts"] + e["dur"]))
        elif cat in _LAUNCH_CATS:
            launch_at[args.get("correlation")] = e["ts"]
        elif cat == "cpu_op":
            op_at[args.get("External id")] = e["ts"]
        elif cat in _DEVICE_CATS:
            device.append(e)
    ops = [(launch_at.get(e.get("args", {}).get("correlation"),
                          op_at.get(e.get("args", {}).get("External id"))),
            e["ts"], e["ts"] + e["dur"]) for e in device]
    rows = phase_rows(spans, ops, n_steps, 1e-3)
    if not device:  # a CPU run: no device time to charge, nor idle
        rows = [r[:3] + (None, None, None) for r in rows]
    return rows


def peak_gbs_of(value: str | None) -> float | None:
    """`--peak_gbs`: a number, or a file holding `tools/hbm_peak.py`'s
    JSON line."""
    if value is None:
        return None
    try:
        return float(value)
    except ValueError:
        with open(value) as f:
            lines = [ln for ln in f.read().splitlines() if ln.startswith("{")]
        return float(json.loads(lines[-1])["measured_peak_gbs"])


def make_workload(cfg, args, device: torch.device, dtype: torch.dtype,
                  group=None):
    """(step, prep, raw): the standard or AdvMix step of the config's
    family, its preprocessor, and a seeded random raw batch of
    BATCH_SIZE_PER_GPU on `device` (bottom-up: whole images of 10 people,
    joints uniform over the image; top-down: crops, joints over the crop)."""
    advmix = bool(args.advmix) and args.sample_times > 1
    bottomup = cfg.MODEL.NAME == "pose_higher_hrnet"
    model = get_pose_net(cfg)
    if advmix:
        state = create_advmix_state(cfg, model, get_generator(args), device,
                                    dtype)
        make = (steps.make_bottomup_advmix_step if bottomup
                else steps.make_advmix_step)
        step = make(state, cfg, alpha=args.alpha,
                    adv_loss_weight=args.adv_loss_weight,
                    num_views=args.sample_times, group=group)
    else:
        state = create_pose_state(cfg, model, device, dtype)
        step = (steps.make_bottomup_step(state, cfg, group=group)
                if bottomup else steps.make_train_step(state, cfg,
                                                       group=group))
    for m in ((state.model_d, state.model_g, state.teacher) if advmix
              else (state.model,)):
        pdist.broadcast_module_(m)
    gen = torch.Generator().manual_seed(pdist.fold_rank(0))
    bs = cfg.TRAIN.BATCH_SIZE_PER_GPU
    w, h = cfg.MODEL.IMAGE_SIZE
    j = cfg.MODEL.NUM_JOINTS
    jshape = (bs, 10, j) if bottomup else (bs, j)
    raw = {"image": torch.randint(0, 256, (bs, h, w, 3), dtype=torch.uint8,
                                  generator=gen),
           "joints": torch.rand(jshape + (2,), generator=gen)
           * (min(w, h) - 2.0),
           "joints_vis": torch.ones(jshape)}
    raw = {k: v.to(device) for k, v in raw.items()}
    prep = (make_bottomup_preprocessor(cfg, advmix, device) if bottomup
            else make_preprocessor(cfg, advmix=advmix, device=device))
    return step, prep, raw


def make_eval_workload(cfg, args, device: torch.device, dtype: torch.dtype,
                       group=None):
    """A call that runs one eval batch and returns its metrics: seeded
    random crops of TEST.BATCH_SIZE_PER_GPU on `device` through the eval
    preprocessor (corrupted by `--corruption_type` at severity
    `--severity` + 1 where one is given, as `tools/test_corruption` runs
    its passes) and the top-down eval step in `dtype`, with the
    dataset's flip pairs (COCO's for 17 joints, MPII's for 16)."""
    model = get_pose_net(cfg).to(device).eval()
    pdist.broadcast_module_(model)
    model = set_compute_dtype(model, dtype)
    j = cfg.MODEL.NUM_JOINTS
    pairs = {17: COCODataset.flip_pairs, 16: MPIIDataset.flip_pairs}.get(
        j, [[i, i + 1] for i in range(0, j - 1, 2)])
    step = steps.make_eval_step(model, cfg, pairs, group=group)
    prep = make_eval_preprocessor(cfg, device,
                                  corruption=args.corruption_type or None,
                                  severity=args.severity + 1)
    gen = torch.Generator().manual_seed(pdist.fold_rank(0))
    bs = cfg.TEST.BATCH_SIZE_PER_GPU
    w, h = cfg.MODEL.IMAGE_SIZE
    image = torch.randint(0, 256, (bs, h, w, 3), dtype=torch.uint8,
                          generator=gen).to(device)
    joints = (torch.rand((bs, j, 2), generator=gen) * (min(w, h) - 2.0)) \
        .to(device)
    vis = torch.ones((bs, j), device=device)
    center = torch.tensor([w / 2.0, h / 2.0], device=device).expand(bs, 2)
    scale = torch.tensor([w / 200.0, h / 200.0], device=device) \
        .expand(bs, 2)

    def one():
        batch = prep(image, joints, vis)
        batch.update(center=center, scale=scale)
        return step(batch)[2]

    return one


def main(argv=None):
    extra = argparse.ArgumentParser(add_help=False)
    extra.add_argument("--eval", action="store_true",
                       help="profile the eval pass, not training")
    extra.add_argument("--profile_steps", type=int, default=5)
    extra.add_argument("--trace_dir", type=str, default=os.path.join(
        tempfile.gettempdir(), "advmix_trace"))
    extra.add_argument("--per_kernel", type=int, default=0,
                       help="also print the top-N kernels")
    extra.add_argument("--peak_gbs", type=str, default=None,
                       help="the card's measured HBM GB/s, or the file of "
                            "tools/hbm_peak.py's JSON line: adds a roofline")
    extra_args, rest = extra.parse_known_args(argv)
    args = parse_args(rest)
    device, launched = ranks(main, args, argv)
    if device is None:
        return launched
    peak_gbs = peak_gbs_of(extra_args.peak_gbs)

    cfg = get_default_config()
    update_config(cfg, args)
    dtype = (torch.bfloat16 if (args.dtype or cfg.TRAIN.DTYPE) == "bfloat16"
             else torch.float32)
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = bool(cfg.CUDNN.BENCHMARK)
    advmix = bool(args.advmix) and args.sample_times > 1
    if extra_args.eval:
        one = make_eval_workload(cfg, args, device, dtype,
                                 pdist.data_group())
        bs, what = cfg.TEST.BATCH_SIZE_PER_GPU, "eval " + (
            f"{args.corruption_type} {args.severity}"
            if args.corruption_type else "clean")
    else:
        step, prep, raw = make_workload(cfg, args, device, dtype,
                                        pdist.data_group())
        gen = torch.Generator().manual_seed(1)
        bs, what = cfg.TRAIN.BATCH_SIZE_PER_GPU, (
            "advmix" if advmix else "standard")

        def one():
            return step(prep(raw, gen))

    metrics = one()  # warm-up: cuDNN's plans, the allocator
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    n = extra_args.profile_steps
    with trace(extra_args.trace_dir, enabled=pdist.is_main()):
        for _ in range(n):
            metrics = one()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    metrics = {k: float(v) for k, v in metrics.items() if v.numel() == 1}
    if not pdist.is_main():
        return metrics

    bs *= pdist.world()
    rows = analyze_trace(extra_args.trace_dir, n)
    tot_t = sum(r[1] for r in rows)
    tot_n = sum(r[2] for r in rows)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"\n=== step profile ({n} steps, batch {bs}, {what}, "
          f"{cfg.MODEL.NAME}, {where}) ===")
    print(f"{'family':28s} {'ms/step':>9s} {'launches':>9s}")
    for fam, t, k in rows:
        print(f"{fam:28s} {t:9.3f} {k:9.1f}")
    print(f"{'TOTAL':28s} {tot_t:9.3f} {tot_n:9.1f}")
    if tot_t:
        print(f"=> {bs * 1e3 / tot_t:.1f} img/s device-side")

    phases = analyze_phases(extra_args.trace_dir, n)
    print("\n=== by phase (per step; the program's spans; device and idle "
          "ms need a card) ===")
    print(f"{'span':24s} {'calls':>6s} {'host ms':>9s} {'device ms':>9s} "
          f"{'idle ms':>9s} {'launches':>9s}")
    for name, calls, host, *dev in phases:
        print(f"{name[:24]:24s} {calls:6.1f} {host:9.3f} "
              + ("" if dev[0] is None else
                 "{:9.3f} {:9.3f} {:9.1f}".format(*dev)))
    builds = None
    if extra_args.eval:
        builds = sum(r[1] for r in phases
                     if r[0] == COUNT_PREFIX + "const_build")
        print(f"corruption constants built a step: {builds:.1f}")

    if extra_args.per_kernel:
        krows = analyze_kernels(extra_args.trace_dir, n, peak_gbs=peak_gbs)
        roof = peak_gbs is not None
        print(f"\n=== top {extra_args.per_kernel} kernels"
              + (f" (roofline: {peak_gbs:.0f} GB/s measured, "
                 f"{H100_BF16_TFLOPS:.0f} TFLOP/s bf16)" if roof else "")
              + " ===")
        print(f"{'kernel':48s} {'ms':>8s} {'GB':>7s} {'GFLOP':>8s} "
              + (f"{'SoL ms':>7s} {'x':>6s} " if roof else "") + f"{'n':>4s}")
        for k, t, b, fl, sol, cnt in krows[:extra_args.per_kernel]:
            x = (t / sol if sol else float("inf")) if roof else None
            roof_s = f"{sol:7.3f} {x:6.1f} " if roof else ""
            print(f"{k[:48]:48s} {t:8.3f} {b:7.3f} {fl:8.2f} {roof_s}"
                  f"{cnt:4d}")
        if roof:
            sol_total = sum(r[4] for r in krows)
            print(f"speed-of-light sum (all kernels): {sol_total:.3f} ms; "
                  f"measured {tot_t:.3f} ms")
    return {"rows": rows, "metrics": metrics, "phases": phases,
            "const_builds_per_step": builds}


if __name__ == "__main__":
    main()
