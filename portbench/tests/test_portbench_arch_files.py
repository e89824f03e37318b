"""A pose architecture joins the benchmark by files alone: its reference
found by `MODEL.NAME` in `portbench/reference/`, every parameter seeded from
the run's seed, the reference's optimizer read from the configuration, the
control reaching any module with a `quant`; and the program's spans and
counters kept in the trace beside the benchmark's own, which they leave as
they were. HRNet-W32's and ResNet-50's seeded weights and FLOP counts are
pinned to the values the harness gave before architectures could be added.
"""

from __future__ import annotations

import copy
import hashlib
import importlib
import sys
import textwrap
import types

import pytest
import torch
from torch import nn

from portbench import core, flops, inputs, trace
from portbench.kinds import common
from portbench.metrics import eval_forward_idle_ms, train_graph_replay_pct
from portbench.reference import models, train
from portbench.tests.tiny import run, tiny_cell

CPU = torch.device("cpu")
TOY = "toy_pose"
TOY_MODEL = {"NAME": TOY, "NUM_JOINTS": 5, "EXTRA": {"WIDTH": 8,
                                                     "GRID": [16, 16]}}

# plain: a conv stem, LayerNorm and a linear layer over the channels, a free
# position table (drawn by torch's default from the global RNG), final_layer
TOY_REFERENCE = '''
import torch
import torch.nn.functional as F
from torch import nn


class Toy(nn.Module):
    def __init__(self, extra, num_joints):
        super().__init__()
        c = extra["WIDTH"]
        self.stem = nn.Sequential(
            nn.Conv2d(3, c, 3, 2, 1, bias=False), nn.BatchNorm2d(c),
            nn.ReLU(), nn.Conv2d(c, c, 3, 2, 1, bias=False),
            nn.BatchNorm2d(c), nn.ReLU())
        self.norm = nn.LayerNorm(c)
        self.mlp = nn.Linear(c, c)
        self.table = nn.Parameter(torch.randn(c, *extra["GRID"]))
        self.final_layer = nn.Conv2d(c, num_joints, 1)

    def forward(self, x):
        x = self.stem(x) + self.table
        y = self.mlp(self.norm(x.permute(0, 2, 3, 1))).permute(0, 3, 1, 2)
        return self.final_layer(F.relu(x + y))


def pose_net(extra, num_joints):
    return Toy(extra, num_joints)
'''

# the program's side, written apart: tokens as rows, the table broadcast
TOY_PROGRAM = '''
import torch
from torch import nn


class ToyPose(nn.Module):
    def __init__(self, width, grid, joints):
        super().__init__()
        self.stem = nn.Sequential(
            nn.Conv2d(3, width, 3, 2, 1, bias=False), nn.BatchNorm2d(width),
            nn.ReLU(), nn.Conv2d(width, width, 3, 2, 1, bias=False),
            nn.BatchNorm2d(width), nn.ReLU())
        self.norm = nn.LayerNorm(width)
        self.mlp = nn.Linear(width, width)
        self.table = nn.Parameter(torch.zeros(width, *grid))
        self.final_layer = nn.Conv2d(width, joints, 1)

    def forward(self, x):
        x = self.stem(x) + self.table[None]
        tokens = x.flatten(2).transpose(1, 2)
        y = self.mlp(self.norm(tokens)).transpose(1, 2).reshape(x.shape)
        return self.final_layer(torch.relu(x + y))


def get_pose_net(cfg, is_train=False):
    e = cfg.MODEL.EXTRA
    return ToyPose(int(e.WIDTH), tuple(e.GRID), int(cfg.MODEL.NUM_JOINTS))
'''


@pytest.fixture
def add_arch(tmp_path, monkeypatch):
    """add_arch(name, reference_source, program_source=None): the files of
    an architecture, found as `portbench.reference.<name>` and
    `advmix_tpu_torch.models.<name>` as if they sat beside the others."""
    import advmix_tpu_torch.models as prog_pkg
    import portbench.reference as ref_pkg

    dirs = {}
    for key, pkg in (("ref", ref_pkg), ("prog", prog_pkg)):
        dirs[key] = tmp_path / key
        dirs[key].mkdir()
        monkeypatch.setattr(pkg, "__path__", [*pkg.__path__, str(dirs[key])])
    added = []

    def add(name, ref_src, prog_src=None):
        (dirs["ref"] / f"{name}.py").write_text(textwrap.dedent(ref_src))
        if prog_src is not None:
            (dirs["prog"] / f"{name}.py").write_text(textwrap.dedent(prog_src))
        importlib.invalidate_caches()
        added.append(name)

    yield add
    for name in added:
        sys.modules.pop(f"portbench.reference.{name}", None)
        sys.modules.pop(f"advmix_tpu_torch.models.{name}", None)


def toy_cell(width: int = 8) -> core.Cell:
    cell = tiny_cell("w32-advmix-b32")
    model = cell.config["yaml"]["MODEL"]
    model.update(copy.deepcopy(TOY_MODEL))
    model["EXTRA"]["WIDTH"] = width
    return cell


def seeded_toy(seed: int, global_seed: int) -> dict:
    torch.manual_seed(global_seed)
    return common.seeded_weights(TOY_MODEL, (64, 64), seed, CPU, False)["d"]


def test_toy_weights_are_a_function_of_the_seed_alone(add_arch):
    add_arch(TOY, TOY_REFERENCE)
    a, b, other = seeded_toy(5, 0), seeded_toy(5, 1), seeded_toy(6, 0)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    # torch's defaults differ with the global seed: none of them is left
    torch.manual_seed(0)
    d0 = models.pose_net(TOY_MODEL).state_dict()
    torch.manual_seed(1)
    d1 = models.pose_net(TOY_MODEL).state_dict()
    drawn = {k for k in d0 if not torch.equal(d0[k], d1[k])}
    assert drawn == {"stem.0.weight", "stem.3.weight", "mlp.weight",
                     "mlp.bias", "table", "final_layer.weight",
                     "final_layer.bias"}
    for k in drawn - {"mlp.bias", "final_layer.bias"}:
        assert not torch.equal(a[k], other[k]), k
    for k in ("mlp.weight", "table"):
        assert 0 < float(a[k].abs().max()) <= 2 * inputs.TABLE_STD
    # N(0, 0.02) cut at two standard deviations keeps 0.88 of its spread
    assert float(a["table"].std()) == pytest.approx(0.88 * inputs.TABLE_STD,
                                                    rel=0.1)
    assert float(a["final_layer.weight"].std()) < 3 * inputs.OUTPUT_STD
    for k in ("norm.weight", "stem.1.weight"):
        assert torch.equal(a[k], torch.ones_like(a[k]))
    for k in ("norm.bias", "mlp.bias", "final_layer.bias", "stem.1.bias"):
        assert torch.equal(a[k], torch.zeros_like(a[k]))


def test_toy_flops_are_counted(add_arch):
    add_arch(TOY, TOY_REFERENCE)
    b, c, j, hw = 2, 8, 5, 16 * 16
    # stem (3x3 convs, 3 -> c at 32x32, c -> c at 16x16), the linear layer
    # and final_layer over 16x16 tokens: two forwards
    one = 2 * b * (c * 32 * 32 * 3 * 9 + c * hw * c * 9 + hw * c * c
                   + j * hw * c)
    assert flops.eval_batch_flops(TOY_MODEL, b, (64, 64)) == 2 * one
    wide = copy.deepcopy(TOY_MODEL)
    wide["EXTRA"]["WIDTH"] = 16
    narrow_it = flops.advmix_iteration_flops(TOY_MODEL, b, (64, 64))
    assert flops.advmix_iteration_flops(wide, b, (64, 64)) > narrow_it > 0


def test_toy_cell_runs_against_the_program(add_arch):
    """The advmix_train kind's whole run on the toy, float32 on the CPU:
    the reference's iterations against the program's, to rounding."""
    add_arch(TOY, TOY_REFERENCE, TOY_PROGRAM)
    r = run(toy_cell())
    assert r["correct"], r["checks"]
    for name, c in r["checks"].items():
        assert c["value"] < 1e-5, (name, c)


BAD_IMPORT = '''
import json
raise RuntimeError("a reference that imports outside the list must not run")
'''
NO_ENTRY = "import torch\n"
LINEAR_HEAD = TOY_REFERENCE.replace("nn.Conv2d(c, num_joints, 1)",
                                    "nn.Linear(c, num_joints)")


@pytest.mark.parametrize("source,error,words", [
    (None, KeyError, "add portbench/reference/"),
    (BAD_IMPORT, ImportError, "imports ['json']"),
    (NO_ENTRY, TypeError, "has no pose_net"),
    (LINEAR_HEAD, TypeError, "final_layer")],
    ids=["missing", "import", "no_entry", "head"])
def test_the_reference_contract_fails_clearly(add_arch, source, error, words):
    if source is not None:
        add_arch(TOY, source)
    with pytest.raises(error, match=words.replace("[", r"\[")
                       .replace("]", r"\]")):
        models.pose_net(TOY_MODEL)


def test_state_names_must_match_the_program(add_arch):
    add_arch(TOY, TOY_REFERENCE, TOY_PROGRAM.replace("self.mlp", "self.ffn"))
    cfg = core.port_config(toy_cell().config)
    w = seeded_toy(5, 0)
    with pytest.raises(KeyError, match=r"reference only \['mlp.bias'"):
        common.port_pose(cfg, w, CPU)


# -- HRNet-W32 and ResNet-50 as before ---------------------------------------

PIN_SEED = 2 ** 31 + 17
# from the harness before this file's change, seed PIN_SEED, on the CPU:
# sha256 of every tensor but the BatchNorm running statistics (whose last
# bits follow the CPU's thread count), the float64 sums of those, and the
# FLOPs of an AdvMix iteration at 32 and of a sweep batch at 128
PINNED = {
    "hrnet-w32-256x192": {
        "d": "ba614da32ea582d454b8f202d926a5fd417c7936ffdca1fd16003a3eaeb5423a",
        "g": "41edae349cb2666fd7be39e4dd02056e8aeec133c538694ca68ad4d269eee7ed",
        "mean": -124.1051169771199, "var": 221164.1031401977,
        "train_flops": 3794389696512, "eval_flops": 3914241933312},
    "resnet50-256x192": {
        "d": "40a9f635f043bb8f29bbe76f7a23bd97cea95e039e42867abea38e8fae7645af",
        "g": None, "mean": 68.34098043208087, "var": 41920.37583748251,
        "train_flops": 2936398675968, "eval_flops": 2778306969600}}


def _digest(state: dict) -> str:
    h = hashlib.sha256()
    for k, v in state.items():
        if not k.endswith(("running_mean", "running_var")):
            h.update(k.encode())
            h.update(v.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("config", sorted(PINNED))
def test_builtin_weights_and_flops_are_pinned(config):
    pin = PINNED[config]
    model = core.load_json(core.HERE, "configs", config + ".json")["yaml"][
        "MODEL"]
    w = common.seeded_weights(model, (192, 256), PIN_SEED, CPU,
                              pin["g"] is not None)
    assert _digest(w["d"]) == pin["d"]
    assert (w["g"] and _digest(w["g"])) == pin["g"]
    for stat in ("mean", "var"):
        total = sum(float(v.double().sum()) for k, v in w["d"].items()
                    if k.endswith("running_" + stat))
        assert total == pytest.approx(pin[stat], rel=1e-4)
    assert flops.advmix_iteration_flops(model, 32, (192, 256)) == \
        pin["train_flops"]
    assert flops.eval_batch_flops(model, 128, (192, 256)) == pin["eval_flops"]


# -- the reference's optimizer ------------------------------------------------

def _reference_pair(opt: str, wd: float):
    torch.manual_seed(0)
    d = models.pose_net(tiny_cell("r50-advmix-b32").config["yaml"]["MODEL"])
    g = models.Unet()
    inputs.he_init_(d, inputs.device_gen(3, 4, CPU))
    inputs.he_init_(g, inputs.device_gen(3, 5, CPU))
    ref = train.AdvMixReference(d, g, 1e-3, 0.1, 1.0, opt, wd)
    same = copy.deepcopy(ref)
    return ref, same


def _three_steps(ref):
    gen = torch.Generator().manual_seed(11)
    for _ in range(3):
        views = torch.randn(2, 9, 64, 64, generator=gen)
        target = torch.rand(2, 17, 16, 16, generator=gen)
        ref.step(views, target, torch.ones(2, 17))
    return {**{("d", k): v for k, v in ref.d.state_dict().items()},
            **{("g", k): v for k, v in ref.g.state_dict().items()}}


@pytest.mark.parametrize("opt", ["adam", "adamw"])
def test_reference_optimizer_from_the_configuration(opt):
    """adam: bit for bit what the reference always ran (Adam without
    weight decay, one tensor at a time); adamw: torch's AdamW with TRAIN.WD,
    for D and G."""
    ref, plain = _reference_pair(opt, 0.05)
    for name, model in (("opt_d", plain.d), ("opt_g", plain.g)):
        if opt == "adam":
            want = torch.optim.Adam(model.parameters(), lr=1e-3, foreach=False)
        else:
            want = torch.optim.AdamW(model.parameters(), lr=1e-3,
                                     weight_decay=0.05)
        setattr(plain, name, want)
        got = getattr(ref, name)
        assert type(got) is type(want)
        assert got.defaults["weight_decay"] == want.defaults["weight_decay"]
    a, b = _three_steps(ref), _three_steps(plain)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_reference_refuses_an_unknown_optimizer():
    with pytest.raises(ValueError, match="no optimizer 'sgd'"):
        train.optimizer("sgd", [nn.Parameter(torch.zeros(1))], 1e-3, 0.0)


def test_control_reaches_any_module_with_a_quant():
    class QuantLinear(nn.Linear):
        quant = None

        def forward(self, x):
            q = self.quant or (lambda t: t)
            return q(nn.functional.linear(q(x), q(self.weight), self.bias))

    m = nn.Sequential(models.Conv(3, 4, 1), QuantLinear(4, 4), nn.Linear(4, 4))
    seen = []

    def quant(t):
        seen.append(t.shape)
        return t

    models.set_quant(m, quant)
    assert m[0].quant is quant and m[1].quant is quant
    assert not hasattr(m[2], "quant")
    m[1](torch.zeros(2, 4))
    assert len(seen) == 3  # input, weight, output
    models.set_quant(m, None)
    assert m[1].quant is None


# -- the program's spans and counters in the trace ---------------------------

class _Event:
    """A profiler event; `kinds` names its activity kind as a torch that
    has `activity_type` does (None: the kind is read from name and
    device)."""

    def __init__(self, name, on_device, start, dur, corr=0, kinds=None):
        self._name, self._dev = name, on_device
        self._start, self._dur, self._corr = start, dur, corr
        if kinds is not None:
            self.activity_type = lambda: kinds

    def name(self):
        return self._name

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return 0


def _events(program: bool, typed: bool) -> list:
    """Two traced iterations of 100 ns, each: to_device, prep, step (where
    three kernels are launched, two of them inside the program's
    `advmix.eval_forward`), sync; with `program`, the program's spans and
    counters, some outside the traced iterations."""
    def ev(name, dev, start, dur, corr=0, kind=None):
        return _Event(name, dev, start, dur, corr, kind if typed else None)

    out = []
    corr = 1
    for base in (0, 100):
        out.append(ev("pb.iter", False, base, 100, kind="user_annotation"))
        for name, s, d in (("pb.to_device", 0, 5), ("pb.prep", 5, 15),
                           ("pb.step", 20, 50), ("pb.sync", 70, 30)):
            out.append(ev(name, False, base + s, d, kind="user_annotation"))
        for launch, start, dur in ((8, 10, 5), (25, 30, 10), (40, 55, 10),
                                   (65, 75, 5)):
            out.append(ev("cudaLaunchKernel", False, base + launch, 1, corr,
                          "cuda_runtime"))
            out.append(ev(f"k{launch}", True, base + start, dur, corr,
                          "kernel"))
            corr += 1
    if program:
        for base in (0, 100):
            out += [ev("advmix.eval_step", False, base + 21, 48, corr,
                       "user_annotation"),
                    ev("advmix.eval_forward", False, base + 22, 28,
                       corr + 1, "user_annotation"),
                    ev("advmix.count.graph_replay", False, base + 23, 0,
                       corr + 2, "user_annotation")]
            corr += 3
        out += [ev("advmix.count.graph_replay", False, 250, 0, corr,
                   "user_annotation"),
                ev("advmix.eval_forward", False, 260, 10, corr + 1,
                   "user_annotation")]
    return out


def _reduced(events: list) -> trace.Trace:
    """`trace.Profiler.reduce` over `events` as the profiler's."""
    p = trace.Profiler.__new__(trace.Profiler)
    p.prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    return p.reduce()


@pytest.mark.parametrize("typed", [False, True], ids=["inferred", "typed"])
def test_program_events_leave_the_benchmark_spans_as_they_were(typed):
    plain = _reduced(_events(False, typed))
    both = _reduced(_events(True, typed))
    assert both.iters == plain.iters == [(0, 100), (100, 200)]
    assert both.spans == plain.spans
    assert [(o.name, o.start, o.end, o.span) for o in both.ops] == \
        [(o.name, o.start, o.end, o.span) for o in plain.ops]
    assert both.breakdown() == plain.breakdown()
    assert plain.program_spans == {} and plain.counts == {}
    # counters and spans inside the traced iterations only
    assert both.counts == {"advmix.count.graph_replay": 2}
    assert both.program_spans == {
        "advmix.eval_step": [(21, 69), (121, 169)],
        "advmix.eval_forward": [(22, 50), (122, 150)]}
    # forward: kernels launched at 25 and 40 (10 + 10 ns), busy 30-40 and
    # 55-65 of which 30-40 lies in 22-50: idle 28 - 10 an iteration
    dev_s, idle_s = both.program_s("advmix.eval_forward")
    assert dev_s == pytest.approx(2 * 20e-9)
    assert idle_s == pytest.approx(2 * 18e-9)
    # the step holds the forward's kernels and the one launched at 65
    dev_s, idle_s = both.program_s("advmix.eval_step")
    assert dev_s == pytest.approx(2 * 25e-9)
    assert idle_s == pytest.approx(2 * (48 - 20) * 1e-9)
    assert both.program_s("advmix.absent") == (0.0, 0.0)


def test_graph_replay_share_reader():
    t = trace.Trace(iters=[(0, 100), (100, 200)], spans={}, ops=[])
    assert train_graph_replay_pct.read(t) is None  # no step counter at all
    t.counts = {"advmix.count.graph_replay": 2}
    assert train_graph_replay_pct.read(t) == 100.0
    t.counts = {"advmix.count.graph_replay": 1,
                "advmix.count.eager_step": 1}
    assert train_graph_replay_pct.read(t) == 50.0
    t.counts = {"advmix.count.eager_step": 2}
    assert train_graph_replay_pct.read(t) == 0.0


def test_eval_forward_idle_reader():
    t = _reduced(_events(True, True))
    assert eval_forward_idle_ms.read(t) == pytest.approx(18e-6)
    t.program_spans = {}
    assert eval_forward_idle_ms.read(t) is None


def test_cpu_run_reads_the_program_counters():
    """On the CPU the step runs eagerly: the traced run counts one eager
    step an iteration and no replay."""
    r = run(tiny_cell("w32-advmix-b32"), trace=True)
    assert r["metrics"]["train_graph_replay_pct"]["value"] == 0.0
