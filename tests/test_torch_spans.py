"""The program's spans and counters (`utils/profiling.span` / `count`) on
the CPU, and what reads them.

- The AdvMix step, the eval step and their preprocessors, run under a CPU
  `torch.profiler`, record each of their `advmix.*` spans once a call,
  each child inside its parent; with no profiler recording, `span` never
  enters `record_function`.
- `ops/corruptions._const` records `advmix.count.const_build` on a miss
  only: a pass's first call builds, its second does not, unless the cache
  is smaller than the cycle of passes.
- The benchmark's trace reduction (`portbench/trace.py`) and its 12
  readers give the same values on an event list with the program's spans
  interleaved as without them (torch 2.11's events: no activity kind).
- `utils/profiling.phase_rows`, `tools/profile.analyze_phases` and the
  cell's phase reader (`portbench/phases.py`) on hand-made traces.
"""

import json
import os
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from advmix_tpu_torch.config import get_default_config
from advmix_tpu_torch.engine import steps, trainer
from advmix_tpu_torch.engine.state import create_advmix_state
from advmix_tpu_torch.models import get_pose_net
from advmix_tpu_torch.models.unet import UnetGenerator
from advmix_tpu_torch.ops import corruptions
from advmix_tpu_torch.tools import profile as profile_tool
from advmix_tpu_torch.utils import profiling
from advmix_tpu_torch.utils.profiling import phase_rows

from torch_dist_worker import stdlib_profile

with stdlib_profile():  # the decode op's first call imports torch._dynamo
    import cProfile  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE_CFG = os.path.join(ROOT, "experiments/synthetic/res18_64x64_smoke.yaml")

ADVMIX_TREE = {"advmix.train_prep": None,
               "advmix.advmix_step": None,
               "advmix.generate": "advmix.advmix_step",
               "advmix.teacher": "advmix.advmix_step",
               "advmix.d_update": "advmix.advmix_step",
               "advmix.d_adam": "advmix.d_update",
               "advmix.g_update": "advmix.advmix_step",
               "advmix.g_adam": "advmix.g_update",
               "advmix.metrics": "advmix.advmix_step"}
EVAL_TREE = {"advmix.eval_prep": None,
             "advmix.corrupt": "advmix.eval_prep",
             "advmix.eval_step": None,
             "advmix.eval_forward": "advmix.eval_step",
             "advmix.eval_score": "advmix.eval_step",
             "advmix.eval_decode": "advmix.eval_step"}


def _cfg(batch=2):
    cfg = get_default_config()
    cfg.merge_from_file(SMOKE_CFG)
    cfg.TRAIN.BATCH_SIZE_PER_GPU = batch
    cfg.MODEL.EXTRA.NUM_DECONV_FILTERS = [16, 16, 16]
    cfg.freeze()
    return cfg


def _raw(cfg, gen):
    b = cfg.TRAIN.BATCH_SIZE_PER_GPU
    w, h = cfg.MODEL.IMAGE_SIZE
    j = cfg.MODEL.NUM_JOINTS
    return {"image": torch.randint(0, 256, (b, h, w, 3), dtype=torch.uint8,
                                   generator=gen),
            "joints": torch.rand((b, j, 2), generator=gen) * (min(w, h) - 2),
            "joints_vis": torch.ones((b, j))}


def _advmix_call():
    torch.manual_seed(0)
    cfg = _cfg()
    g = UnetGenerator(input_nc=9, output_nc=3, num_downs=6, ngf=8)
    state = create_advmix_state(cfg, get_pose_net(cfg), g,
                                torch.device("cpu"))
    step = steps.make_advmix_step(state, cfg)
    prep = trainer.make_preprocessor(cfg, advmix=True,
                                     device=torch.device("cpu"))
    gen = torch.Generator().manual_seed(1)
    raw = _raw(cfg, gen)
    return lambda: step(prep(raw, gen))


def _eval_call():
    torch.manual_seed(0)
    cfg = _cfg()
    model = get_pose_net(cfg).eval()
    step = steps.make_eval_step(model, cfg, [(1, 2), (3, 4)])
    prep = trainer.make_eval_preprocessor(cfg, torch.device("cpu"),
                                          corruption="defocus_blur",
                                          severity=1)
    raw = _raw(cfg, torch.Generator().manual_seed(1))
    b = raw["image"].shape[0]

    def call():
        batch = prep(raw["image"], raw["joints"], raw["joints_vis"])
        batch.update(center=torch.full((b, 2), 32.0),
                     scale=torch.ones((b, 2)))
        return step(batch)

    return call


def _program_spans(fn, n=1) -> list:
    """(name, start, end) of the `advmix.*` ranges recorded while `fn` runs
    `n` times under a CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(n):
            fn()
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith(profiling.PREFIX)),
                  key=lambda s: (s[1], -s[2]))


@pytest.mark.parametrize("make, tree", [(_advmix_call, ADVMIX_TREE),
                                        (_eval_call, EVAL_TREE)],
                         ids=["advmix_step", "eval_step"])
def test_spans_once_a_call_inside_their_parents(make, tree):
    call = make()
    call()  # outside the profiler: the warm-up
    spans = _program_spans(call, n=2)
    names = [s[0] for s in spans if not s[0].startswith(
        profiling.COUNT_PREFIX)]
    assert sorted(set(names)) == sorted(tree)
    assert all(names.count(k) == 2 for k in tree)
    for name, s, e in spans:
        parent = tree.get(name)
        if parent is None:
            continue
        assert any(p == parent and ps <= s and e <= pe
                   for p, ps, pe in spans), (name, parent)


def test_no_profiler_never_enters_record_function(monkeypatch):
    advmix, evaluate = _advmix_call(), _eval_call()

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    corruptions.release_constants()  # so that _const builds, and counts
    assert np.isfinite(float(advmix()["loss_d"]))
    assert np.isfinite(float(evaluate()[2]["loss"]))
    with profiling.span("advmix.x"):
        profiling.count("x")


def _one_pass(name, severity):
    img = torch.rand((1, 32, 32, 3), generator=torch.Generator()
                     .manual_seed(0)) * 255.0
    return lambda: corruptions.corrupt(
        img, name, severity, torch.Generator().manual_seed(1),
        exact_render=True)


def _builds(spans) -> int:
    return sum(s[0] == "advmix.count.const_build" for s in spans)


def test_const_build_counted_on_a_miss_only():
    corruptions.release_constants()
    call = _one_pass("defocus_blur", 2)
    assert _builds(_program_spans(call)) > 0
    assert _builds(_program_spans(call)) == 0


PASSES = (("defocus_blur", 1), ("defocus_blur", 3), ("motion_blur", 2),
          ("zoom_blur", 1), ("elastic_transform", 1), ("glass_blur", 1))


@pytest.mark.parametrize("cache", [256, 2])
def test_a_cycle_of_passes_rebuilds_only_past_the_cache(cache, monkeypatch):
    monkeypatch.setattr(corruptions, "MAX_CONSTANTS", cache)
    corruptions.release_constants()
    calls = [_one_pass(n, s) for n, s in PASSES]

    def cycle():
        for c in calls:
            c()

    first = _program_spans(cycle)
    again = _program_spans(cycle)
    rows = {r[0]: r for r in phase_rows(again, [], len(PASSES), 1e-6)}
    if cache == 256:
        assert _builds(first) > 0 and _builds(again) == 0
        assert "advmix.count.const_build" not in rows
    else:  # the cache holds 2 of the cycle's constants: every pass rebuilds
        assert _builds(again) == _builds(first) > len(PASSES)
        assert rows["advmix.count.const_build"][1] > 1.0
    corruptions.release_constants()


# -- the benchmark's reduction, with and without the program's spans --------

class _Ev:
    """A profiler event as torch 2.11 gives it: no activity kind."""

    def __init__(self, name, host, start, dur, corr=0, linked=0):
        self._v = (name, host, start, dur, corr, linked)

    def name(self):
        return self._v[0]

    def device_type(self):
        return "DeviceType.CPU" if self._v[1] else "DeviceType.CUDA"

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]


def _events(program: bool) -> list:
    """Two iterations of a step: host spans, operators, launches, kernels,
    copies and the device's copies of the ranges; with `program`, the
    `advmix.*` ranges and count events (host and device copies) too."""
    ev, corr = [], [100]

    def nid():
        corr[0] += 1
        return corr[0]

    for it in range(2):
        t0 = it * 10_000_000
        ev.append(_Ev("pb.iter", True, t0, 9_000_000, nid()))
        for name, s, d in (("pb.to_device", 0, 500_000),
                           ("pb.prep", 600_000, 900_000),
                           ("pb.step", 1_600_000, 6_000_000),
                           ("pb.sync", 7_700_000, 1_200_000)):
            ev.append(_Ev(name, True, t0 + s, d, nid()))
            ev.append(_Ev(name, False, t0 + s + 50_000, d, nid()))
        # kernels launched inside to_device, prep, step (twice) and sync,
        # one a memcpy, one known only through its operator
        for k, (at, kname) in enumerate(((100_000, "Memcpy HtoD"),
                                         (700_000, "warp_kernel"),
                                         (2_000_000, "sm90_xmma_gemm"),
                                         (5_000_000, "decode_kernel"),
                                         (8_000_000, "reduce_kernel"))):
            op = nid()
            ev.append(_Ev("aten::op", True, t0 + at - 10_000, 50_000, op))
            c = nid()
            if k != 3:
                ev.append(_Ev("cudaLaunchKernel", True, t0 + at, 5_000, c))
            ev.append(_Ev(kname, False, t0 + at + 300_000, 200_000 + k,
                          c, op))
        if program:
            for name, s, d in (("advmix.train_prep", 620_000, 800_000),
                               ("advmix.advmix_step", 1_650_000, 5_000_000),
                               ("advmix.d_update", 1_900_000, 1_000_000),
                               ("advmix.count.const_build", 4_000_000, 0),
                               ("advmix.eval_decode", 4_900_000, 200_000)):
                ev.append(_Ev(name, True, t0 + s, d, nid()))
                ev.append(_Ev(name, False, t0 + s + 40_000, d, nid()))
    return sorted(ev, key=lambda e: (e.start_ns(), not e._v[1]))


def _profiler(program: bool):
    """The benchmark's `Profiler` holding `_events(program)`."""
    from portbench import trace as tr

    p = tr.Profiler.__new__(tr.Profiler)
    evs = _events(program)
    p.prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: evs)))
    return p


def _reduced(program: bool, reduce=None):
    from portbench import trace as tr

    t = (reduce or tr.Profiler.reduce)(_profiler(program))
    t.iter_s = [0.4, 0.5, 0.45]
    t.flops_per_iter = 3.0e12
    t.extra = {"decode_bytes": 1_000_000}
    return t


def test_benchmark_readers_unmoved_by_program_spans():
    from portbench import core

    bench = core.benchmark()
    base, prog = _reduced(False), _reduced(True)
    assert base.iters == prog.iters and base.spans == prog.spans
    assert [vars(o) for o in base.ops] == [vars(o) for o in prog.ops]
    assert sum(o.span is not None for o in base.ops) == 10
    assert base.busy_s() == prog.busy_s() and base.gaps() == prog.gaps()
    assert base.breakdown() == prog.breakdown()
    names = [m["name"] for m in bench["per_layer"]]
    assert len(names) >= 12
    for name in names:
        read = core.metric_reader(name).read
        assert read(base) == read(prog), name


# -- the readers of the program's spans --------------------------------------

def test_cell_phase_reader_on_a_hand_made_trace():
    from portbench import phases, trace as tr

    got = {}
    t = _reduced(True, phases.reading_reduce(tr.Profiler.reduce, got))
    assert [vars(o) for o in t.ops] == [vars(o) for o in _reduced(True).ops]
    rows = {r[0]: r[1:] for r in got["rows"]}
    assert list(rows) == ["advmix.train_prep", "advmix.advmix_step",
                          "advmix.d_update", "advmix.count.const_build",
                          "advmix.eval_decode"]
    # per iteration, in ms: D's update (1.9-2.9) launched the gemm, whose
    # 0.200002 ms run inside it; the step holds it and the decode kernel
    # its operator launched from inside the decode span
    assert rows["advmix.d_update"] == pytest.approx(
        [1.0, 1.0, 0.200002, 0.799998, 1.0])
    assert rows["advmix.advmix_step"] == pytest.approx(
        [1.0, 5.0, 0.400005, 4.599995, 2.0])
    assert rows["advmix.eval_decode"] == pytest.approx(
        [1.0, 0.2, 0.200003, 0.2, 1.0])  # its kernel runs after it closes
    assert rows["advmix.count.const_build"][0] == 1.0
    assert got["step_device_ms"] == pytest.approx(0.400005)
    assert got["phase_sums_device_ms"] == pytest.approx(
        {"train": 0.200002, "eval": 0.200003})
    # a gap is labelled by the innermost program span open at its start
    labels = [g[0] for g in got["idle_gaps"]]
    assert labels[:4] == ["pb.step > advmix.d_update"] * 2 \
        + ["pb.step > advmix.advmix_step"] * 2
    assert "pb.prep > advmix.train_prep" in labels and "pb.sync" in labels
    assert (got["gaps"], got["gaps_in_a_program_span"]) == (11, 6)
    plain = {}
    _reduced(False, phases.reading_reduce(tr.Profiler.reduce, plain))
    assert plain["rows"] == [] and plain["phase_sums_device_ms"] == {}
    assert plain["gaps_in_a_program_span"] == 0
    assert [g[0] for g in plain["idle_gaps"]] == \
        [g[0] for g in _reduced(False).breakdown()["idle_gaps"]]


def test_phase_rows_on_a_hand_made_trace():
    spans = [("advmix.a", 0, 100), ("advmix.b", 10, 50),
             ("advmix.all_reduce", 120, 140), ("advmix.all_reduce", 125, 135),
             ("advmix.count.x", 60, 60)]
    ops = [(20, 30, 60), (70, 80, 90), (None, 0, 5), (200, 200, 210),
           (126, 130, 150)]
    rows = {r[0]: r[1:] for r in phase_rows(spans, ops, 2, 1.0)}
    assert list(rows) == ["advmix.a", "advmix.b", "advmix.count.x",
                          "advmix.all_reduce"]
    # a: ops launched at 20 and 70 (40 of device); busy [0,5) [30,60)
    # [80,90) inside it: 45 of its 100 covered
    assert rows["advmix.a"] == (0.5, 50.0, 20.0, 27.5, 1.0)
    assert rows["advmix.b"] == (0.5, 20.0, 15.0, 10.0, 0.5)
    assert rows["advmix.count.x"] == (0.5, 0.0, 0.0, 0.0, 0.0)
    # nested calls of one name are read as their union
    assert rows["advmix.all_reduce"] == (1.0, 10.0, 10.0, 5.0, 0.5)
    assert phase_rows([], ops, 2, 1.0) == []
    assert phase_rows(spans, ops, 0, 1.0) == []


def test_analyze_phases_reads_the_chrome_trace(tmp_path):
    ev = [{"ph": "X", "cat": "user_annotation", "name": "advmix.g_update",
           "ts": 0.0, "dur": 100.0},
          {"ph": "X", "cat": "user_annotation", "name": "pb.step",
           "ts": 0.0, "dur": 300.0},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
           "ts": 10.0, "dur": 5.0, "args": {"correlation": 7}},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 40.0, "dur": 30.0,
           "args": {"correlation": 7, "External id": 3}},
          {"ph": "X", "cat": "cpu_op", "name": "aten::x", "ts": 90.0,
           "dur": 2.0, "args": {"External id": 4}},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy", "ts": 95.0,
           "dur": 10.0, "args": {"correlation": 8, "External id": 4}},
          {"ph": "X", "cat": "kernel", "name": "late", "ts": 200.0,
           "dur": 10.0, "args": {"correlation": 9}}]
    (tmp_path / "trace.json").write_text(json.dumps({"traceEvents": ev}))
    rows = profile_tool.analyze_phases(str(tmp_path), 1)
    assert len(rows) == 1
    name, calls, host, dev, idle, k = rows[0]
    assert (name, calls, k) == ("advmix.g_update", 1.0, 2.0)
    assert abs(host - 0.1) < 1e-12 and abs(dev - 0.04) < 1e-12
    assert abs(idle - 0.065) < 1e-12  # 40 + 25 us with nothing running
    (tmp_path / "trace.json").write_text(json.dumps(
        {"traceEvents": [e for e in ev if e["name"] != "advmix.g_update"]}))
    assert profile_tool.analyze_phases(str(tmp_path), 1) == []
