"""The AdvMix step's CUDA-graph path, as far as the CPU can check it.

On a card, for one rank, without debug outputs, planted faults or an int8
teacher, `steps.make_advmix_step` runs its first iteration eagerly and
replays the rest as a CUDA graph (`steps._GraphedIteration`); everywhere
else it runs eagerly. Here:

- the decision (`steps.graphs_iteration`) over the device, the group,
  `debug`, `_mutation` and the teacher's kind;
- the capture key (`steps.graph_key`): another learning rate, a resumed
  optimizer state, a new batch shape or a parameter moved by `Module.to`
  change it; a fresh batch of the same shapes does not;
- `steps.make_capturable_` sets Adam's `capturable` and leaves SGD be;
- on the CPU, under a profiler, every call counts `advmix.count.eager_step`
  and none counts a capture or a replay or opens `advmix.graph_replay`;
- which path each call of `_GraphedIteration` takes (eager, capture,
  replay), with `torch.cuda`'s stream and graph objects stood in for by
  ones that run nothing, with cuDNN autotuning off and on.

The graph itself needs a card: `tests/test_torch_gpu.py`.
"""

import contextlib
import copy
import io

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from advmix_tpu_torch.config import get_default_config
from advmix_tpu_torch.engine import optim, steps
from advmix_tpu_torch.engine.state import create_advmix_state
from advmix_tpu_torch.models import get_pose_net
from advmix_tpu_torch.models.unet import UnetGenerator
from advmix_tpu_torch.utils import profiling

CPU, CUDA = torch.device("cpu"), torch.device("cuda", 0)


def _cfg(optimizer="adam"):
    cfg = get_default_config()
    cfg.MODEL.NAME = "pose_resnet"
    cfg.MODEL.NUM_JOINTS = 6
    cfg.MODEL.IMAGE_SIZE = [64, 64]
    cfg.MODEL.HEATMAP_SIZE = [16, 16]
    cfg.MODEL.EXTRA.NUM_LAYERS = 18
    cfg.MODEL.EXTRA.NUM_DECONV_LAYERS = 3
    cfg.MODEL.EXTRA.NUM_DECONV_FILTERS = [16, 16, 16]
    cfg.MODEL.EXTRA.NUM_DECONV_KERNELS = [4, 4, 4]
    cfg.MODEL.EXTRA.DECONV_WITH_BIAS = False
    cfg.MODEL.EXTRA.FINAL_CONV_KERNEL = 1
    cfg.TRAIN.OPTIMIZER = optimizer
    cfg.TRAIN.LR = 1e-3
    return cfg


def _state(optimizer="adam"):
    torch.manual_seed(0)
    cfg = _cfg(optimizer)
    return cfg, create_advmix_state(cfg, get_pose_net(cfg),
                                    UnetGenerator(ngf=8), CPU)


def _batch(n=2, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {"views": torch.randn((n, 9, 64, 64), generator=gen),
            "target": torch.rand((n, 6, 16, 16), generator=gen),
            "target_weight": torch.ones((n, 6))}


@pytest.mark.parametrize("device, group, debug, mutation, int8, graphs", [
    (CUDA, None, False, None, False, True),
    (CPU, None, False, None, False, False),
    (CUDA, "group", False, None, False, False),
    (CUDA, None, True, None, False, False),
    (CUDA, None, False, "single_bn_update", False, False),
    (CUDA, None, False, "stale_d_in_g_step", False, False),
    (CUDA, None, False, None, True, False),
], ids=["card", "cpu", "ranks", "debug", "single_bn_update",
        "stale_d_in_g_step", "int8_teacher"])
def test_graph_or_eager(device, group, debug, mutation, int8, graphs):
    assert steps.graphs_iteration(device, group, debug, mutation,
                                  int8) is graphs


@pytest.fixture(scope="module")
def stepped():
    """A state after one eager step, so that Adam's state exists."""
    cfg, state = _state()
    steps.make_advmix_step(state, cfg)(_batch())
    return cfg, state


def _opts(state):
    return state.optimizer_d, state.optimizer_g


def test_key_holds_for_fresh_tensors_of_the_same_shapes(stepped):
    _, state = stepped
    key = steps.graph_key(_batch(seed=0), _opts(state))
    assert steps.graph_key(_batch(seed=1), _opts(state)) == key
    n_params = sum(len(g["params"]) for opt in _opts(state)
                   for g in opt.param_groups)
    assert len(key[2]) == 2 * n_params  # its storage, its state's dict


@pytest.mark.parametrize("change", ["lr", "load_state_dict", "batch_shape",
                                    "views_dtype", "module_to"])
def test_key_changes_with_what_the_graph_closed_over(change):
    cfg, state = _state()
    step = steps.make_advmix_step(state, cfg)
    step(_batch())
    batch = _batch()
    key = steps.graph_key(batch, _opts(state))
    if change == "lr":
        optim.set_learning_rate(state.optimizer_g, 1e-4)
    elif change == "load_state_dict":  # a resume: new tensors, same values
        buf = io.BytesIO()
        torch.save(state.optimizer_d.state_dict(), buf)
        buf.seek(0)
        state.optimizer_d.load_state_dict(torch.load(buf))
    elif change == "batch_shape":
        batch = _batch(n=3)
    elif change == "views_dtype":
        batch["views"] = batch["views"].double()
    else:
        state.model_d.final_layer.to(torch.float64)
    assert steps.graph_key(batch, _opts(state)) != key


def test_key_ignores_a_tensor_learning_rate(stepped):
    _, state = stepped
    opt = copy.deepcopy(state.optimizer_g)
    key = steps.graph_key(_batch(), (opt,))
    for group in opt.param_groups:
        group["lr"] = torch.tensor(5e-4)
    with_tensor = steps.graph_key(_batch(), (opt,))
    assert with_tensor[2] == key[2] and with_tensor != key
    for group in opt.param_groups:
        group["lr"] = torch.tensor(1e-5)  # written in place: no new capture
    assert steps.graph_key(_batch(), (opt,)) == with_tensor


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_make_capturable(optimizer):
    cfg, state = _state(optimizer)
    steps.make_advmix_step(state, cfg)(_batch())
    steps.make_capturable_(_opts(state))
    for opt in _opts(state):
        for group in opt.param_groups:
            assert group.get("capturable") is (
                True if optimizer == "adam" else None)
            for p in group["params"]:
                if optimizer == "adam":
                    assert opt.state[p]["step"].device == p.device


def _counts(events) -> dict:
    out = {}
    for e in events:
        if e.name().startswith(profiling.PREFIX):
            out[e.name()] = out.get(e.name(), 0) + 1
    return out


def test_cpu_steps_count_as_eager_and_never_as_a_graph():
    cfg, state = _state()
    step = steps.make_advmix_step(state, cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for seed in range(3):
            step(_batch(seed=seed))
    counts = _counts(prof.profiler.kineto_results.events())
    assert counts[profiling.COUNT_PREFIX + "eager_step"] == 3
    assert counts["advmix.advmix_step"] == 3
    for name in ("graph_capture", "graph_replay"):
        assert profiling.COUNT_PREFIX + name not in counts
    assert "advmix.graph_replay" not in counts
    assert state.step == 3
    assert all(g.get("capturable") is False for opt in _opts(state)
               for g in opt.param_groups)  # the eager path leaves Adam be


class _Stream:
    def __init__(self, *_):
        pass

    def wait_stream(self, _):
        pass


class _Graph:
    def replay(self):
        pass


@pytest.mark.parametrize("benchmark, paths", [
    (False, ["eager", "capture", "replay", "capture", "capture", "replay"]),
    (True, ["eager", "capture", "replay", "capture", "eager", "capture"]),
], ids=["heuristics", "autotuned"])
def test_path_of_each_call(benchmark, paths, monkeypatch):
    """Calls 1-3 at one shape, 4 at a new learning rate, 5 and 6 at a new
    batch size: under cuDNN autotuning call 5 runs eagerly (a capture
    cannot time algorithms) and call 6 captures."""
    for name, value in (("Stream", _Stream),
                        ("current_stream", lambda *_: _Stream()),
                        ("stream", lambda _: contextlib.nullcontext()),
                        ("CUDAGraph", _Graph),
                        ("graph", lambda *_, **__: contextlib.nullcontext())):
        monkeypatch.setattr(torch.cuda, name, value)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", benchmark)
    real = steps.graphs_iteration
    monkeypatch.setattr(steps, "graphs_iteration",
                        lambda _, *a: real(CUDA, *a))
    monkeypatch.setattr(steps, "make_capturable_", lambda _: None)
    cfg, state = _state()
    step = steps.make_advmix_step(state, cfg)
    seen, outs = [], []
    for i, n in enumerate((2, 2, 2, 2, 3, 3)):
        if i == 3:
            optim.set_learning_rate(state.optimizer_d, 1e-4)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            outs.append((step(_batch(n, seed=i)), step.last_mix_weights))
        counts = _counts(prof.profiler.kineto_results.events())
        seen.append("capture" if counts.get("advmix.count.graph_capture")
                    else "replay" if counts.get("advmix.count.graph_replay")
                    else "eager")
        assert counts.get("advmix.count.eager_step", 0) == (
            seen[-1] == "eager")
        assert counts.get("advmix.graph_replay", 0) == (seen[-1] != "eager")
        assert state.step == i + 1
    assert seen == paths
    # a replay hands out copies of the graph's outputs
    (m2, w2), (m3, w3) = outs[1], outs[2]
    assert w3 is not w2 and torch.equal(w3, w2)
    assert all(m3[k] is not m2[k] for k in m2)
