"""The readings that the output check's limits are set from, on the chip.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 \
        [--control_seeds 1,2,3] [--fault_seeds 1,2,3] [--seconds 3]

For each seed, in one process: the program's numbers (the set-up's first
steps, or a short window of the cell's own load), the control's (the
reference in float8 put in the program's place, on the same inputs) and,
for the fault seeds, the numbers of each fault that the cell can have
planted under the timed path (`faults.py`). Witnesses: `--dtype float64`
runs both sides in float64; `--perturb 1e-12,1e-6` reads the reference
against itself with its inputs perturbed. Prints one JSON line per
reading and a summary line last: the largest program reading and the
smallest control and fault readings of each number. The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s.strip()]


def readings(cell, seeds, control_seeds, fault_seeds, seconds, device,
             emit=print, float64=False, perturb=()) -> list:
    """All readings of `cell` as dicts {seed, side, numbers}."""
    import torch

    from portbench import core, faults
    from portbench.reference import evaluate, numerics

    cfg = core.port_config(cell.config)
    torch.backends.cudnn.benchmark = bool(cfg.CUDNN.BENCHMARK)
    kind = core.kind_module(cell.traffic)
    train = cell.traffic["kind"] == "advmix_train"
    fault_kinds = ("half_batch", "unchanged", "g_unchanged",
                   "single_bn_update") if train else ("half_batch", "answer")
    out = []

    def record(seed, side, numbers, why=None):
        r = {"seed": seed, "side": side, "numbers": numbers}
        if why:
            r["worst_leaf"] = why
        out.append(r)
        emit(json.dumps(r))

    def program(seed, fault=None):
        ctx = core.Context(cell=cell, cfg=cfg, seed=seed, device=device,
                           float64=float64)
        with faults.planted(fault):
            work = kind.CellRun(ctx)
            work.setup()
            if not train:
                core.measure(work, seconds)
        work.release()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        return work

    for seed in sorted(set(seeds) | set(control_seeds) | set(fault_seeds)):
        t0 = time.time()
        work = program(seed)
        if train:
            ref = work.reference()
            if seed in seeds:
                why = {}
                record(seed, "program",
                       work.compare(work.program_readings(), ref, why), why)
            for eps in perturb if seed in seeds else ():
                why = {}
                record(seed, f"perturbed:{eps:g}",
                       work.compare(work.reference(perturb=eps), ref, why),
                       why)
            if seed in control_seeds:
                why = {}
                ctl = work.reference(numerics.fp8_quant)
                record(seed, "control", work.compare(ctl, ref, why), why)
            if seed in fault_seeds:
                for f in fault_kinds:
                    bad = program(seed, f)
                    why = {}
                    record(seed, f"fault:{f}",
                           bad.compare(bad.program_readings(), ref, why), why)
        else:
            if seed in seeds:
                record(seed, "program", work.check())
            if seed in control_seeds:
                with numerics.exact_f32():
                    ref_m = work.reference_model()
                    ctl_m = work.reference_model(numerics.fp8_quant)
                    answers = []
                    for i in work.check_batches():
                        pool_i, pass_i = work.answers[i][:2]
                        hb = work.pool[pool_i]
                        hm = work.reference_heatmaps(pool_i, pass_i, ctl_m)
                        xy, m = evaluate.decode(hm)
                        pr = evaluate.to_image(
                            xy, torch.from_numpy(hb["center"]).to(device),
                            torch.from_numpy(hb["scale"]).to(device),
                            hm.shape[2:])
                        answers.append((pool_i, pass_i,
                                        pr.to(torch.float32).cpu().numpy(),
                                        m[..., None].cpu().numpy()))
                    record(seed, "control", work.judge(answers, ref_m))
                del ref_m, ctl_m
            if seed in fault_seeds:
                for f in fault_kinds:
                    record(seed, f"fault:{f}", program(seed, f).check())
        del work
        if device.type == "cuda":
            torch.cuda.empty_cache()
        print(f"[calibrate] seed {seed}: {time.time() - t0:.1f} s",
              file=sys.stderr, flush=True)
    return out


def summary(rows: list) -> dict:
    s = {}
    for r in rows:
        for k, v in r["numbers"].items():
            e = s.setdefault(k, {})
            side = r["side"]
            if side == "program":
                e["program_max"] = max(e.get("program_max", v), v)
            else:
                e[f"{side}_min"] = min(e.get(f"{side}_min", v), v)
    return s


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control_seeds", default="")
    p.add_argument("--fault_seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--perturb", default="",
                   help="training cells: also the reference against itself "
                        "with its views scaled by 1 + eps N(0, 1), for each "
                        "eps of this list (the numbers' own sensitivity)")
    p.add_argument("--dtype", default=None,
                   choices=("float32", "bfloat16", "float64"),
                   help="run the program in this TRAIN.DTYPE instead of the "
                        "configuration's (a witness, not the cell); float64 "
                        "runs both sides' models in float64 on float32 "
                        "views, the program's TF32 off")
    args = p.parse_args(argv)

    import torch

    from portbench import core

    if not torch.cuda.is_available():
        print("[calibrate] no CUDA device", file=sys.stderr)
        return 3
    cell = core.find_cell(core.benchmark(), args.workload)
    float64 = args.dtype == "float64"
    if args.dtype:
        cell.config["yaml"]["TRAIN"]["DTYPE"] = \
            "float32" if float64 else args.dtype
    if float64:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    rows = readings(cell, _seeds(args.seeds), _seeds(args.control_seeds),
                    _seeds(args.fault_seeds), args.seconds,
                    torch.device("cuda", 0), float64=float64,
                    perturb=[float(e) for e in args.perturb.split(",") if e])
    print(json.dumps({"workload": args.workload, "dtype": args.dtype,
                      "summary": summary(rows),
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
