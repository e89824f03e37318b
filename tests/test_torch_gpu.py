"""Each CUDA kernel of the port against its plain PyTorch version, on a card.

These tests need a CUDA device and nvcc; without a card they skip. The
file imports nothing of JAX, so it also runs where only the port is
installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(`--noconftest` skips `tests/conftest.py`, which imports jax.) The inputs
are `chip_smoke.py`'s, at the eval path's shapes and at shapes that cross
the kernels' tile, vector and alignment edges.

Tolerances: decode is bit-equal (the same comparisons, the same f32 adds
of 0.25), at COCO's and MPII's shapes; soft-argmax (plain PyTorch) within
1e-3 heatmap px of the CPU. OKS: rtol 1e-5, atol 1e-6, since CUDA's `expf` and torch's `exp`
may differ in the last bit. Keep lists: equal. Corruptions (plain PyTorch on
the card, no hand kernel): the card and the CPU at most 1 uint8 level apart
on at most 0.5% of values. The bottom-up infer (plain PyTorch, no hand
kernel) in float64: the card equals the CPU to 1e-12 of the range. The
int8 convolution (im2col + `torch._int_mm`, a library GEMM) is bit-equal
to its CPU route, a float64 convolution of the codes; an exported program
launches the decode kernel once per call, and a server answers one input
twice with the same bits where autotuning in a fresh thread does not. Two
ranks on the card(s) take the float64 AdvMix step of one rank on their
halves of its batch, within 1e-9 of the update's range. Window attention
(`csrc/window_attn.cu`) against its plain version on the card: in f32 the
output and every gradient within 1e-5 of their range (the same f32
arithmetic summed in another order, and `expf` against torch's `exp`); in
bf16 within 1e-2 of the range (both take the same bf16 inputs and sum in
f32, the tensor-core kernels with P and dS as a pair of bf16, ~16 bits,
and each rounds its bf16 outputs, and bf16 holds 8 bits: 2^-8 of a
value); bf16 calls take the tensor-core route and f32 calls the f32 one;
the backward gives the same bits twice (no atomics), and a model block's
attention goes through the kernels forward and backward.
"""

import numpy as np
import pytest
import torch

from advmix_tpu_torch.native import greedy_from_matrix
from advmix_tpu_torch.ops.cuda.decode_kernel import (decode_heatmaps,
                                                     decode_heatmaps_plain,
                                                     decode_route)
from advmix_tpu_torch.ops.cuda.oks_kernel import (oks_matrix,
                                                  oks_matrix_batched,
                                                  oks_matrix_batched_plain)
from advmix_tpu_torch.ops.cuda.timing import (decode_by, oks_baseline,
                                              oks_by_micro)
from advmix_tpu_torch.ops.nms import oks_nms_np
from chip_smoke import card_vs_cpu, decode_inputs, flat_kpts, oks_inputs


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("post_process", [True, False])
def test_cuda_decode_matches_plain(cuda, post_process):
    hm = torch.from_numpy(decode_inputs(np.random.RandomState(0))).to(cuda)
    before = decode_heatmaps.launches
    ck, mk = decode_heatmaps(hm, post_process)
    assert decode_heatmaps.launches == before + 1
    cp, mp = decode_heatmaps_plain(hm, post_process)
    assert torch.equal(ck, cp) and torch.equal(mk, mp)


def shifted_view(t: torch.Tensor) -> torch.Tensor:
    """`t`'s values in a contiguous view one element into a fresh buffer:
    4-byte aligned, neither 8 nor 16."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype,
                      device=t.device)[1:].view_as(t)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 8 == 4
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("shape,shift,route", [
    ((3, 5, 17, 13), False, "scalar"),   # H*W % 4 != 0
    ((2, 17, 64, 48), True, "scalar"),   # a 4-byte aligned view
    ((2, 17, 64, 48), False, "vector"),
    ((3, 5, 16, 12), False, "vector"),   # 15 maps: not whole blocks of 4
    ((1, 1, 2, 2), False, "vector")])    # one 16-byte value per map
@pytest.mark.parametrize("post_process", [True, False])
def test_cuda_decode_routes_match_plain(cuda, shape, shift, route,
                                        post_process):
    rng = np.random.RandomState(sum(shape))
    hm = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(cuda)
    hm[0, 0] = torch.round(hm[0, 0] * 2) / 2  # exact ties
    if shift:
        hm = shifted_view(hm)
    assert decode_route(shape[2], shape[3], hm.data_ptr()) == route
    before = decode_heatmaps.launches
    ck, mk = decode_heatmaps(hm, post_process)
    assert decode_heatmaps.launches == before + 1
    cp, mp = decode_heatmaps_plain(hm, post_process)
    assert torch.equal(ck, cp) and torch.equal(mk, mp)


@pytest.mark.gpu
@pytest.mark.parametrize("design", ["scalar", "vector"])
def test_cuda_decode_designs_match_plain(cuda, design):
    """Either route, forced on the aligned eval-path maps, computes the
    same function."""
    hm = torch.from_numpy(decode_inputs(np.random.RandomState(0))).to(cuda)
    for post_process in (True, False):
        ck, mk = decode_by(design, hm, post_process)
        cp, mp = decode_heatmaps_plain(hm, post_process)
        assert torch.equal(ck, cp) and torch.equal(mk, mp)


@pytest.mark.gpu
@pytest.mark.parametrize("design", ["scalar", "vector"])
def test_cuda_decode_at_mpii_shape_matches_plain(cuda, design):
    """MPII's eval batch (128, 16, 64, 64): either route, bit for bit."""
    hm = torch.from_numpy(decode_inputs(np.random.RandomState(1), 128, 16,
                                        64, 64)).to(cuda)
    for post_process in (True, False):
        ck, mk = decode_by(design, hm, post_process)
        cp, mp = decode_heatmaps_plain(hm, post_process)
        assert torch.equal(ck, cp) and torch.equal(mk, mp)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(128, 17, 64, 48), (128, 16, 64, 64)])
def test_cuda_soft_argmax_matches_cpu(cuda, shape):
    """TEST.SOFT_ARGMAX's decode (plain PyTorch, no hand kernel): the card's
    coordinates within 1e-3 heatmap px of the CPU's (the softmax and the
    sums of 3,072 or 4,096 terms are ordered differently)."""
    from advmix_tpu_torch.ops.heatmap import soft_argmax
    from chip_smoke import peaked_maps

    hm = torch.from_numpy(peaked_maps(np.random.RandomState(2), *shape))
    pc, mc = soft_argmax(hm.to(cuda))
    pr, mr = soft_argmax(hm)
    assert float((pc.cpu() - pr).abs().max()) <= 1e-3
    near = ((pr - pr.floor() - 0.5).abs() < 1e-3).any(-1)
    assert not ((mc.cpu() != mr)[..., 0] & ~near).any()


@pytest.mark.gpu
@pytest.mark.parametrize("m,p", [
    (64, 2), (64, 15), (64, 16), (64, 17), (64, 33), (64, 128), (47, 32),
    (1, 2), (1, 33), (1, 128), (1, 130), (1, 300)])
def test_cuda_oks_matches_plain(cuda, m, p):
    """M=1 goes through the single-image wrapper (N=130 and 300 cross tile
    edges). The matrix is symmetric to the bit, every micro-tile size
    gives the same bits, and the keep lists of the greedy scan over the
    kernel's matrices equal the numpy OKS-NMS oracle."""
    kpts, scores, areas = oks_inputs(np.random.RandomState(m + p), m, p)
    kt = torch.from_numpy(kpts).to(cuda)
    at = torch.from_numpy(areas.astype(np.float32)).to(cuda)
    wrapper = oks_matrix if m == 1 else oks_matrix_batched
    before = wrapper.launches
    got = oks_matrix(kt[0], at[0])[None] if m == 1 else oks_matrix_batched(
        kt, at)
    assert wrapper.launches == before + 1
    want = oks_matrix_batched_plain(kt, at)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert torch.equal(got, got.transpose(1, 2))
    for micro in (1, 2, 4):
        assert torch.equal(oks_by_micro(kt, at, micro), got)
    torch.testing.assert_close(oks_baseline(kt, at), want, rtol=1e-5,
                               atol=1e-6)
    sims = got.cpu().numpy()
    for i in range(min(m, 4)):
        keep = greedy_from_matrix(sims[i], scores[i].astype(np.float32), 0.9)
        assert keep == oks_nms_np(flat_kpts(kpts[i].astype(np.float64)),
                                  scores[i], areas[i], 0.9)


@pytest.mark.gpu
def test_cuda_oks_takes_a_4_byte_aligned_view(cuda):
    """The kernel loads (x, y) as one 8-byte value; the wrapper realigns a
    view that is not 8-byte aligned."""
    kpts, _, areas = oks_inputs(np.random.RandomState(5), 3, 33)
    kt = torch.from_numpy(kpts).to(cuda)
    at = torch.from_numpy(areas.astype(np.float32)).to(cuda)
    assert torch.equal(oks_matrix_batched(shifted_view(kt), shifted_view(at)),
                       oks_matrix_batched(kt, at))


# ---------------------------------------------------------------------------
# AdvMix training on the card (no hand kernel: torch and cuDNN ops)
# ---------------------------------------------------------------------------

def _tiny_train_cfg():
    from advmix_tpu_torch.config import get_default_config

    cfg = get_default_config()
    cfg.MODEL.NAME = "pose_resnet"
    cfg.MODEL.NUM_JOINTS = 6
    cfg.MODEL.IMAGE_SIZE = [64, 64]
    cfg.MODEL.HEATMAP_SIZE = [16, 16]
    cfg.MODEL.EXTRA.NUM_LAYERS = 18
    cfg.MODEL.EXTRA.NUM_DECONV_LAYERS = 3
    cfg.MODEL.EXTRA.NUM_DECONV_FILTERS = [32, 32, 32]
    cfg.MODEL.EXTRA.NUM_DECONV_KERNELS = [4, 4, 4]
    cfg.MODEL.EXTRA.DECONV_WITH_BIAS = False
    cfg.MODEL.EXTRA.FINAL_CONV_KERNEL = 1
    cfg.TRAIN.OPTIMIZER = "adam"
    return cfg


@pytest.mark.gpu
def test_cuda_views_equal_cpu_views(cuda):
    """The 3-view synthesis on the card is the CPU's to the bit in f32 for
    integer-valued crops: integer histograms, exact LUTs, masks."""
    from advmix_tpu_torch.ops.augment import (draw_advmix_views,
                                              make_advmix_views)

    img = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (8, 3, 64, 48)).astype(np.float32))
    draws = draw_advmix_views(8, 64, 48, torch.Generator().manual_seed(1))
    want = make_advmix_views(img, draws=draws)
    on_card = {part: {k: v.to(cuda) for k, v in d.items()}
               for part, d in draws.items()}
    got = make_advmix_views(img.to(cuda), draws=on_card)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=2e-6)
    seeded = make_advmix_views(img.to(cuda),
                               torch.Generator().manual_seed(1))
    assert torch.equal(seeded, got)  # the draws do not depend on the device


@pytest.mark.gpu
def test_cuda_warp_affine_equals_cpu(cuda):
    from advmix_tpu_torch.ops.transforms import (get_affine_transform,
                                                 warp_affine)

    rng = np.random.RandomState(2)
    img = torch.from_numpy(rng.randint(0, 256, (4, 200, 240, 3)).astype(
        np.uint8))
    mats = torch.from_numpy(np.stack([get_affine_transform(
        rng.uniform(60, 140, 2), rng.uniform(0.4, 1.2) * np.ones(2),
        rng.uniform(-40, 40), (48, 64)) for _ in range(4)]).astype(
            np.float32))
    want = warp_affine(img, mats, (48, 64))
    got = warp_affine(img.to(cuda), mats.to(cuda), (48, 64)).cpu()
    # f32 coordinates; the card may contract a*x + b*y + c into FMAs
    torch.testing.assert_close(got, want, rtol=0, atol=0.05)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_advmix_step_invariants(cuda, dtype):
    """Three AdvMix iterations on the card (eager, captured, replayed):
    f32 master weights, two BN updates per iteration, an untouched
    teacher, finite losses of the right signs."""
    from advmix_tpu_torch.engine.state import create_advmix_state
    from advmix_tpu_torch.engine.steps import make_advmix_step
    from advmix_tpu_torch.models import get_pose_net
    from advmix_tpu_torch.models.unet import UnetGenerator

    cfg = _tiny_train_cfg()
    state = create_advmix_state(cfg, get_pose_net(cfg),
                                UnetGenerator(ngf=8), cuda, dtype)
    teacher0 = {k: v.clone() for k, v in state.teacher.state_dict().items()}
    d0 = [p.detach().clone() for p in state.model_d.parameters()]
    step = make_advmix_step(state, cfg, alpha=0.3, adv_loss_weight=0.7)
    rng = np.random.RandomState(3)
    for _ in range(3):
        batch = dict(
            views=torch.from_numpy(rng.randn(4, 9, 64, 64).astype(
                np.float32)).to(cuda, dtype),
            target=torch.from_numpy(rng.rand(4, 6, 16, 16).astype(
                np.float32)).to(cuda),
            target_weight=torch.ones(4, 6, device=cuda))
        m = {k: float(v) for k, v in step(batch).items()}
        assert np.isfinite(m["loss_d"]) and m["loss_d"] > 0 > m["loss_g"]
        w = step.last_mix_weights
        assert w.dtype == torch.float32
        torch.testing.assert_close(w.sum(1), torch.ones_like(w[:, 0]))
    assert all(p.dtype == torch.float32 for p in state.model_d.parameters())
    assert all(p.dtype == torch.float32 for p in state.model_g.parameters())
    assert any(not torch.equal(a, b) for a, b in
               zip(d0, state.model_d.parameters()))
    assert int(state.model_d.bn1.num_batches_tracked) == 6
    assert state.step == 3
    for k, v in state.teacher.state_dict().items():
        assert torch.equal(v, teacher0[k])


GRAPH_CALLS = (4, 4, 4, 4, 6)  # the batch of each call; the lr changes at 4


def _graph_batches(dtype):
    rng = np.random.RandomState(11)
    return [dict(views=torch.from_numpy(rng.randn(n, 9, 64, 64)).to(dtype),
                 target=torch.from_numpy(rng.rand(n, 6, 16, 16)).to(
                     torch.float64 if dtype == torch.float64
                     else torch.float32),
                 target_weight=torch.from_numpy(
                     (rng.rand(n, 6) > 0.2) * 1.0).to(
                     torch.float64 if dtype == torch.float64
                     else torch.float32))
            for n in GRAPH_CALLS]


def _trained_leaves(state) -> dict:
    """Every parameter, D's BN statistics and Adam's state (once made), on
    the host."""
    out = {}
    for net, m, opt in (("d", state.model_d, state.optimizer_d),
                        ("g", state.model_g, state.optimizer_g)):
        for k, p in m.named_parameters():
            out[f"{net}.{k}"] = p.detach().cpu()
            out.update({f"{net}.{k}.{s}": v.cpu().double() if s == "step"
                        else v.cpu() for s, v in opt.state[p].items()})
        if net == "d":
            out.update({f"d.{k}": v.detach().cpu()
                        for k, v in m.named_buffers()})
    return out


def _leaf_kind(key: str) -> tuple:
    """(net, kind) of a `_trained_leaves` key: a parameter, a BN statistic
    or one of Adam's state entries."""
    last = key.rsplit(".", 1)[-1]
    kind = (last if last in ("exp_avg", "exp_avg_sq", "step")
            else "stat" if "running_" in key else "param")
    return key.split(".", 1)[0], kind


def _graph_run(cuda, dtype, debug: bool):
    """Five AdvMix calls from the same weights and batches (the last a new
    batch size), the learning rate cut before the fourth. Returns the
    state, each call's metrics and mixing weights (read back at once),
    the third call's outputs as returned, and the counters' events."""
    from torch.profiler import ProfilerActivity, profile

    from advmix_tpu_torch.engine import optim
    from advmix_tpu_torch.engine.state import create_advmix_state
    from advmix_tpu_torch.engine.steps import make_advmix_step
    from advmix_tpu_torch.models import get_pose_net, he_reinit_convs
    from advmix_tpu_torch.models.unet import UnetGenerator

    cfg = _tiny_train_cfg()
    torch.manual_seed(0)  # what the constructors draw (G's conv biases)
    model, g = get_pose_net(cfg), UnetGenerator(ngf=8)
    he_reinit_convs(model, torch.Generator().manual_seed(0))
    he_reinit_convs(g, torch.Generator().manual_seed(1))
    if dtype == torch.float64:
        model, g = model.double(), g.double()
    state = create_advmix_state(cfg, model, g, cuda, dtype)
    start = {k: v.clone() for k, v in _trained_leaves(state).items()}
    step = make_advmix_step(state, cfg, alpha=0.3, adv_loss_weight=0.7,
                            debug=debug)
    calls, third = [], None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i, batch in enumerate(_graph_batches(dtype)):
            if i == 3:
                for opt in (state.optimizer_d, state.optimizer_g):
                    optim.set_learning_rate(opt, 2e-4)
            out = step({k: v.to(cuda) for k, v in batch.items()})
            metrics = out[0] if debug else out
            if i == 2:
                third = (metrics, step.last_mix_weights)
            calls.append(({k: float(v) for k, v in metrics.items()},
                          step.last_mix_weights.cpu()))
    return state, start, calls, third, _host_counts(prof)


def _host_counts(prof) -> dict:
    """The step's counters and `advmix.graph_replay` spans on the host (a
    CUDA profiler also shows a span's range on the device's timeline)."""
    counts = {}
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CPU") and (
                e.name().startswith("advmix.count.")
                or e.name() == "advmix.graph_replay"):
            counts[e.name()] = counts.get(e.name(), 0) + 1
    return counts


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_cuda_graphed_advmix_step_matches_eager(cuda, dtype, monkeypatch):
    """Five calls of the graphed AdvMix step (eager, capture, replay, a
    capture at a new learning rate, a capture at a new batch size) against
    a `debug=True` step, which stays eager, from the same weights and
    batches. float64 (default dtype float64, so that Adam's device step
    count and bias corrections are float64 as the eager step's are;
    deterministic cuDNN on both): every parameter, BN statistic and Adam
    moment within 1e-12 of its tensor's range, or of the median range of
    its kind where that is larger. bf16: the benchmark's own limits
    (`portbench/limits/w32-advmix-b32.json`) on the losses of every call,
    the mixing weights of the first replay and the change of D, G and D's
    BN statistics. The counters: 1 eager step, 3 captures, 4 replays; the
    third call's outputs survive the fourth."""
    import json
    import os

    from portbench.reference import train as ref_train

    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic",
                        dtype == torch.float64)
    if dtype == torch.float64:
        default = torch.get_default_dtype()
        torch.set_default_dtype(torch.float64)
    try:
        graphed, start, g_calls, third, counts = _graph_run(cuda, dtype,
                                                            False)
        eager, _, e_calls, _, e_counts = _graph_run(cuda, dtype, True)
    finally:
        if dtype == torch.float64:
            torch.set_default_dtype(default)

    assert counts == {"advmix.count.eager_step": 1,
                      "advmix.count.graph_capture": 3,
                      "advmix.count.graph_replay": 4,
                      "advmix.graph_replay": 4}
    assert e_counts == {"advmix.count.eager_step": 5}
    assert graphed.step == eager.step == 5
    metrics3, mix3 = third
    assert {k: float(v) for k, v in metrics3.items()} == g_calls[2][0]
    assert torch.equal(mix3.cpu(), g_calls[2][1])  # call 4 left them be
    got, want = _trained_leaves(graphed), _trained_leaves(eager)
    assert got.keys() == want.keys()
    if dtype == torch.float64:
        spans = {k: float(w.max() - w.min()) for k, w in want.items()
                 if w.is_floating_point()}
        median = {kind: ref_train.median([v for k, v in spans.items()
                                          if _leaf_kind(k) == kind])
                  for kind in {_leaf_kind(k) for k in spans}}
        for k, w in want.items():
            if not w.is_floating_point():
                assert torch.equal(got[k], w), k
                continue
            # a leaf of round-off (the moments of a conv bias in front of
            # an InstanceNorm, whose gradient is 0) against its kind's
            # median range
            scale = max(spans[k], median[_leaf_kind(k)]) \
                or float(w.abs().max())
            assert float((got[k] - w).abs().max()) <= 1e-12 * scale, k
        for (gm, gw), (em, ew) in zip(g_calls, e_calls):
            for k, v in em.items():
                assert abs(gm[k] - v) <= 1e-12 * max(abs(v), 1.0), k
            assert float((gw - ew).abs().max()) <= 1e-12
        return
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "portbench/limits/w32-advmix-b32.json")) as f:
        limits = json.load(f)
    for (gm, gw), (em, ew) in zip(g_calls, e_calls):
        for key in ("loss_d", "loss_g"):
            gap = abs(gm[key] - em[key]) / max(abs(em[key]), 1e-12)
            assert gap <= limits[f"{key}_gap"], (key, gm, em)
    # G's mix at its first replay (one identical eager update behind it);
    # later, bf16 rounding in Adam's first, sign-like steps moves G apart
    assert ref_train.mix_diff(g_calls[1][1], e_calls[1][1]) \
        <= limits["mix1_diff"]
    for net, limit in (("d", "change_d_median_gap"),
                       ("g", "change_g_median_gap")):
        names = [k for k in want if k.startswith(net + ".")
                 and k.rsplit(".", 1)[-1] in ("weight", "bias")
                 and "running_" not in k]
        moving = ref_train.moving_leaves(
            {k: want[k + ".exp_avg"] for k in names})
        gaps = ref_train.leaf_numbers(
            {k: got[k] - start[k] for k in names},
            {k: want[k] - start[k] for k in names}, moving)["gap"]
        assert ref_train.median(list(gaps.values())) <= limits[limit], net
    bn = [k for k in want if k.endswith(("running_mean", "running_var"))]
    gaps = ref_train.leaf_numbers({k: got[k] - start[k] for k in bn},
                                  {k: want[k] - start[k] for k in bn})["gap"]
    assert ref_train.median(list(gaps.values())) \
        <= limits["change_bn_median_gap"]


@pytest.mark.gpu
def test_cuda_autotuned_new_batch_size_runs_eagerly_then_captures(
        cuda, monkeypatch):
    """Under cuDNN autotuning a batch size the step has not run eagerly
    runs eagerly once (cuDNN cannot time its algorithms inside a capture),
    and the next call at that size captures: calls at batch 4, 4, 4, 6, 6,
    6 go eager, capture, replay, eager, capture, replay."""
    from torch.profiler import ProfilerActivity, profile

    from advmix_tpu_torch.engine.state import create_advmix_state
    from advmix_tpu_torch.engine.steps import make_advmix_step
    from advmix_tpu_torch.models import get_pose_net
    from advmix_tpu_torch.models.unet import UnetGenerator

    monkeypatch.setattr(torch.backends.cudnn, "benchmark", True)
    cfg = _tiny_train_cfg()
    state = create_advmix_state(cfg, get_pose_net(cfg),
                                UnetGenerator(ngf=8), cuda, torch.bfloat16)
    step = make_advmix_step(state, cfg, alpha=0.3, adv_loss_weight=0.7)
    rng = np.random.RandomState(5)
    losses = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for n in (4, 4, 4, 6, 6, 6):
            m = step(dict(
                views=torch.from_numpy(rng.randn(n, 9, 64, 64)).to(
                    cuda, torch.bfloat16),
                target=torch.from_numpy(rng.rand(n, 6, 16, 16)).to(
                    cuda, torch.float32),
                target_weight=torch.ones(n, 6, device=cuda)))
            losses.append(float(m["loss_d"]))
    assert _host_counts(prof) == {"advmix.count.eager_step": 2,
                                  "advmix.count.graph_capture": 2,
                                  "advmix.count.graph_replay": 4,
                                  "advmix.graph_replay": 4}
    assert np.isfinite(losses).all() and state.step == 6


@pytest.mark.gpu
def test_cuda_f32_advmix_step_matches_cpu(cuda):
    """One f32 SGD AdvMix step of PoseResNet-18 on the card against the CPU
    (TF32 off): every parameter within 2e-2 of its tensor's largest
    update."""
    from advmix_tpu_torch.engine.state import create_advmix_state
    from advmix_tpu_torch.engine.steps import make_advmix_step
    from advmix_tpu_torch.models import get_pose_net, he_reinit_convs
    from advmix_tpu_torch.models.unet import UnetGenerator

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _tiny_train_cfg()
    cfg.TRAIN.OPTIMIZER = "sgd"
    cfg.TRAIN.LR = 0.01
    rng = np.random.RandomState(4)
    batch = dict(
        views=torch.from_numpy(rng.randn(4, 9, 64, 64).astype(np.float32)),
        target=torch.from_numpy(rng.rand(4, 6, 16, 16).astype(np.float32)),
        target_weight=torch.ones(4, 6))
    after = []
    for dev in (torch.device("cpu"), cuda):
        model = get_pose_net(cfg)
        he_reinit_convs(model, torch.Generator().manual_seed(0))
        g = UnetGenerator(ngf=8)
        he_reinit_convs(g, torch.Generator().manual_seed(1))
        with torch.no_grad():  # the constructor drew them unseeded
            for name, p in g.named_parameters():
                if name.endswith("bias"):
                    p.zero_()
        start = [p.detach().clone() for p in model.parameters()]
        state = create_advmix_state(cfg, model, g, dev, torch.float32)
        make_advmix_step(state, cfg, 0.3, 0.7)(
            {k: v.to(dev) for k, v in batch.items()})
        after.append([p.detach().cpu() for p in state.model_d.parameters()])
    for p0, a, b in zip(start, *after):
        moved = float((a - p0).abs().max())
        assert moved > 0
        assert float((a - b).abs().max()) <= 2e-2 * moved


# one severity per corruption form that draws nothing at random: the 8
# key-free types and the exact-render forms (spatter 4 is the mud arm, 2
# the water arm, which needs cv2)
KEY_FREE = ["defocus_blur", "zoom_blur", "brightness", "contrast", "pixelate",
            "jpeg_compression", "gaussian_blur", "saturate"]
CORRUPTION_CASES = ([(n, 3, False) for n in KEY_FREE]
                    + [(n, 3, True) for n in ("glass_blur", "motion_blur",
                                              "snow", "elastic_transform")]
                    + [("spatter", 4, True), ("spatter", 2, True)])


@pytest.mark.gpu
@pytest.mark.parametrize("name,severity,exact", CORRUPTION_CASES)
def test_cuda_corruption_matches_cpu(cuda, name, severity, exact):
    """The card against the CPU on 4 seeded 256x192 crops, with cuDNN TF32
    allowed around the call (the module turns it off for its own convs),
    in uint8 after clip and truncation: at most 1 level apart on at most
    0.5% of values."""
    if name == "spatter" and severity <= 3:
        pytest.importorskip("cv2", reason="the exact water arm needs cv2")
    x = torch.from_numpy(np.random.RandomState(10).randint(
        0, 256, (4, 256, 192, 3)).astype(np.float32))
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=True, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=True):
        level, share = card_vs_cpu(x, cuda, name, severity, exact)
    assert level <= 1 and share <= 0.005, (level, share)


@pytest.mark.gpu
@pytest.mark.parametrize("name", KEY_FREE + [
    "gaussian_noise", "shot_noise", "impulse_noise", "speckle_noise",
    "glass_blur", "motion_blur", "snow", "frost", "fog", "elastic_transform",
    "spatter"])
def test_cuda_traced_corruption_in_range(cuda, name):
    """The generator-driven form on the card: shape, finite, [0, 255], and
    two seeds differ where the form draws at random."""
    from advmix_tpu_torch.ops.corruptions import DRAWS, corrupt

    x = torch.from_numpy(np.random.RandomState(11).randint(
        0, 256, (4, 256, 192, 3)).astype(np.float32)).to(cuda)
    a, b = (corrupt(x, name, 3, torch.Generator(cuda).manual_seed(s))
            for s in (1, 2))
    for out in (a, b):
        assert out.shape == x.shape and torch.isfinite(out).all()
        assert float(out.min()) >= 0 and float(out.max()) <= 255
    assert torch.equal(a, b) != (name in DRAWS)


@pytest.mark.gpu
@pytest.mark.parametrize("scales", [(1.0,), (0.5, 1.0, 2.0)])
def test_cuda_bottomup_infer_float64_matches_cpu(cuda, scales):
    """HigherHRNet-W32 at full width (seeded weights, BN calibrated) and a
    256x256 input: the bottom-up infer in float64 (flip test, the given
    TEST.SCALE_FACTOR) on the card equals the CPU's to 1e-12 of the range,
    heatmaps, tags and the peaks above 0.1, which sit at the same pixels."""
    from advmix_tpu_torch.config import get_default_config
    from chip_smoke import HIGHER_CFG, bottomup_infer_card_vs_cpu, \
        random_model

    cfg = get_default_config()
    cfg.merge_from_file(HIGHER_CFG)
    cfg.MODEL.IMAGE_SIZE = [256, 256]
    cfg.MODEL.HEATMAP_SIZE = [64, 64]
    cfg.TEST.SCALE_FACTOR = list(scales)
    cfg.freeze()
    model = random_model(cfg, torch.device("cpu"))
    x = torch.from_numpy(np.random.RandomState(12).randn(1, 256, 256, 3))
    pairs = [[2 * i + 1, 2 * i + 2] for i in range(8)]
    r = bottomup_infer_card_vs_cpu(model, cfg, x, pairs, cuda)
    assert r["shape"] == (1, 17, 128, 128)
    assert r["heat"] < 1e-12 and r["tags"] < 1e-12, r
    assert r["n_above"] > 0 and r["same_pixels"] and r["peak_val"] < 1e-12, r


INT8_CONVS = [  # batch, cin, h, w, cout, kernel, stride, padding
    (2, 3, 256, 192, 32, 3, 2, 1),     # HRNet's stem: depth 27
    (2, 64, 64, 48, 64, 3, 1, 1),
    (2, 32, 64, 48, 64, 3, 2, 1),
    (2, 256, 64, 48, 64, 1, 1, 0),     # the channels-last reshape only
    (1, 256, 8, 6, 256, 3, 1, 1),      # 48 rows
    (3, 40, 5, 7, 20, 3, 1, 1),        # 105 rows, width 20: all padded
    (1, 8, 3, 3, 12, 1, 1, 0),         # 9 rows
    (7, 64, 2, 2, 64, 3, 2, 1),        # 7 rows, a polymorphic batch
]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", INT8_CONVS)
def test_cuda_int8_conv2d_matches_cpu(cuda, shape):
    from advmix_tpu_torch.ops.int8_conv import int8_conv2d

    b, c, h, w, o, k, s, p = shape
    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randint(-127, 128, (b, c, h, w), generator=g, dtype=torch.int8)
    wq = torch.randint(-127, 128, (o, c, k, k), generator=g,
                       dtype=torch.int8)
    before = int8_conv2d.launches
    got = int8_conv2d(x.to(cuda), wq.to(cuda), [s, s], [p, p])
    assert int8_conv2d.launches == before + 1
    assert got.dtype == torch.int32 and got.is_cuda
    assert torch.equal(got.cpu(), int8_conv2d(x, wq, [s, s], [p, p]))


@pytest.mark.gpu
def test_cuda_quantized_model_matches_cpu(cuda):
    """PoseResNet-18 64x64 W8A8 in f32 on the card and on the CPU: the
    same int8 codes go in, the same int32 sums come out; the rest is cuDNN
    against the CPU, so within 1e-4 of the range."""
    from advmix_tpu_torch.config import load_config
    from advmix_tpu_torch.models import get_pose_net, he_reinit_convs
    from advmix_tpu_torch.ops import quant

    torch.backends.cudnn.allow_tf32 = False
    cfg = load_config("experiments/synthetic/res18_64x64_smoke.yaml")
    model = get_pose_net(cfg)
    he_reinit_convs(model, torch.Generator().manual_seed(1))
    x = torch.from_numpy(np.random.RandomState(2).randn(4, 3, 64, 64)
                         .astype(np.float32))
    q = quant.quantize_model(model.eval(),
                             quant.calibrate_act_scales(model.eval(), [x]))
    with torch.no_grad():
        ref = q(x)
        got = q.to(cuda)(x.to(cuda)).cpu()
    rng = float(ref.max() - ref.min())
    assert float((got - ref).abs().max()) <= 1e-4 * rng


@pytest.mark.gpu
def test_cuda_exported_program_launches_decode(cuda, tmp_path):
    from advmix_tpu_torch.tools import export as export_tool
    from advmix_tpu_torch.tools import serve as serve_tool

    export_tool.main([
        "--cfg", "experiments/synthetic/res18_64x64_smoke.yaml", "--batch",
        "0", "--out", str(tmp_path / "e"), "--int8"])
    server = serve_tool.PoseServer(str(tmp_path / "e"))
    assert server.device.type == "cuda"
    x = np.random.RandomState(3).randn(5, 64, 64, 3).astype(np.float32)
    before = decode_heatmaps.launches
    first = server.predict(x)
    assert decode_heatmaps.launches == before + 1
    assert np.array_equal(first, server.predict(x))
    assert decode_heatmaps.launches == before + 2
    with pytest.raises(ValueError, match="exported on cuda"):
        serve_tool.PoseServer(str(tmp_path / "e"), "cpu")


@pytest.mark.gpu
def test_cuda_polymorphic_int8_predict_repeats_at_new_batch_sizes(
        cuda, tmp_path):
    """A batch-polymorphic int8 export, warmed at batch 1, answers twice
    with the same bits at three batch sizes it meets for the first time,
    in a process that autotunes cuDNN's plans and allows nondeterministic
    ones: the server's device calls allow only deterministic plans."""
    from advmix_tpu_torch.tools import export as export_tool
    from advmix_tpu_torch.tools import serve as serve_tool

    export_tool.main([
        "--cfg", "experiments/synthetic/res18_64x64_smoke.yaml", "--batch",
        "0", "--out", str(tmp_path / "e"), "--int8"])
    cudnn = torch.backends.cudnn
    before = cudnn.benchmark, cudnn.deterministic
    cudnn.benchmark, cudnn.deterministic = True, False
    try:
        server = serve_tool.PoseServer(str(tmp_path / "e"))
        x = np.random.RandomState(4).randn(17, 64, 64, 3).astype(np.float32)
        for b in (3, 9, 17):
            first = server.predict(x[:b])
            assert first.shape == (b, 8, 3) and np.isfinite(first).all()
            assert np.array_equal(first, server.predict(x[:b])), b
        assert (cudnn.benchmark, cudnn.deterministic) == (True, False)
        server.close()
    finally:
        cudnn.benchmark, cudnn.deterministic = before


@pytest.mark.gpu
def test_cuda_repeat_probe_separates_server_from_autotuning(cuda, tmp_path):
    """tools/serve_check's repeat probe at batch sizes 1..48: with autotuning
    on and nondeterministic plans allowed, PoseResNet-18 64x64's transposed
    convs can answer one input twice with other bits; through
    `PoseServer.call`, which allows deterministic plans only, never. A
    server that inherits the process's flags fails here whenever autotuning
    picks such a plan for it (on an H100 with PyTorch 2.11: at batch sizes 1
    and 2 in each of 4 processes). The fresh thread's count varies from run
    to run (0 to 4 sizes), so it is not held."""
    from advmix_tpu_torch.tools import export as export_tool
    from advmix_tpu_torch.tools import serve as serve_tool
    from advmix_tpu_torch.tools.serve_check import repeat_probe

    export_tool.main([
        "--cfg", "experiments/synthetic/res18_64x64_smoke.yaml", "--batch",
        "0", "--out", str(tmp_path / "e")])
    server = serve_tool.PoseServer(str(tmp_path / "e"))
    probe = repeat_probe(server, 48)
    server.close()
    assert probe["server"] == [], probe


@pytest.mark.gpu
def test_cuda_two_ranks_match_one_rank_float64(cuda, tmp_path):
    """Two ranks (NCCL on two cards, else gloo on one) take one float64
    AdvMix step with TRAIN.CROSS_REPLICA_BN on their halves of a batch of
    4; one rank takes it on the whole batch: D's and G's updates agree
    within 1e-9 of their range."""
    from advmix_tpu_torch.config import load_config
    from advmix_tpu_torch.models import get_pose_net, he_reinit_convs
    from advmix_tpu_torch.parallel.dist import launch
    from chip_smoke import dist_devices, f64_two_vs_one

    cfg = load_config("experiments/synthetic/res18_64x64_smoke.yaml")
    model = get_pose_net(cfg)
    he_reinit_convs(model, torch.Generator().manual_seed(4))
    torch.save(model.state_dict(), str(tmp_path / "d.pth"))
    gaps = launch(f64_two_vs_one, dist_devices(), cfg, str(tmp_path / "d.pth"))
    assert gaps["d"] < 1e-9 and gaps["g"] < 1e-9, gaps


# (B, H, W, C, heads): HRFormer-B's four branches at batch 32, small maps
# that leave most of a window padded, at head dims 8 to 40, and an odd C,
# whose token runs the bf16 kernels copy an element at a time
WINDOW_ATTN_CASES = [(32, 64, 48, 78, 2), (32, 32, 24, 156, 4),
                     (32, 16, 12, 312, 8), (32, 8, 6, 624, 16),
                     (3, 9, 11, 24, 3), (2, 5, 3, 96, 3), (1, 14, 7, 64, 2),
                     (2, 7, 9, 39, 1)]


def _window_attn_gaps(cuda, shape, dtype):
    from advmix_tpu_torch.ops.cuda import window_attention as wa
    from chip_smoke import window_attn_inputs

    b, h, w, c, heads = shape
    qkv, bias, table, dout = window_attn_inputs(cuda, b, h, w, c, heads,
                                                dtype, seed=sum(shape))
    ops = torch.ops.advmix_tpu_torch
    route = "mma" if dtype == torch.bfloat16 else "simt"
    assert wa.kernel_route(dtype) == route
    before = wa.window_attention.launches
    routed = wa.window_attention.routes[route]
    out, lse = ops.window_attn(qkv, bias, table, heads, 7)
    grads = ops.window_attn_backward(dout, qkv, bias, table, lse, heads, 7)
    again = ops.window_attn_backward(dout, qkv, bias, table, lse, heads, 7)
    torch.cuda.synchronize()
    assert wa.window_attention.launches == before + 5
    assert wa.window_attention.routes[route] == routed + 5
    assert all(torch.equal(x, y) for x, y in zip(grads, again))
    po, pl = wa.window_attention_plain(qkv, bias, table, heads, 7)
    plain = wa.window_attention_plain_backward(dout, qkv, bias, table, heads,
                                               7)

    def gap(x, y):
        y = y.float()
        return float((x.float() - y).abs().max() / y.abs().max())

    real = torch.isfinite(pl)  # every query's log-sum the kernel wrote
    nh, nw = wa.num_windows(h, w, 7)
    top, _, left, _ = wa.centre_pad(h, w, 7)
    rows = torch.zeros((nh * 7, nw * 7), dtype=torch.bool, device=cuda)
    rows[top:top + h, left:left + w] = True
    rows = rows.view(nh, 7, nw, 7).permute(0, 2, 1, 3).reshape(-1, 49)
    real = real & rows.repeat(b, 1)[:, None, :]
    return {"out": gap(out, po), "lse": gap(lse[real], pl[real]),
            "dqkv": gap(grads[0], plain[0]), "dbias": gap(grads[1], plain[1]),
            "dtable": gap(grads[2], plain[2])}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", WINDOW_ATTN_CASES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_cuda_window_attention_matches_plain(cuda, shape, dtype, tol):
    gaps = _window_attn_gaps(cuda, shape, dtype)
    assert max(gaps.values()) < tol, gaps


@pytest.mark.gpu
def test_cuda_hrformer_block_runs_the_kernels(cuda):
    """A bf16 HRFormer block trains through the kernels on the card, and
    its output and gradients agree with the same block on the CPU's plain
    path in f32 to bf16's rounding."""
    from advmix_tpu_torch.models.pose_hrformer import HRFormerBlock
    from advmix_tpu_torch.ops.cuda.window_attention import window_attention

    torch.manual_seed(0)
    block = HRFormerBlock(78, 2, 7, 4.0, 0.0, 0).train()
    x = torch.randn(4, 78, 16, 12)
    ref_x = x.clone().requires_grad_(True)
    ref = block(ref_x)
    ref.square().mean().backward()
    ref_grads = {k: p.grad.clone() for k, p in block.named_parameters()}
    block.zero_grad()
    card = block.to(cuda)
    cx = x.to(cuda, torch.bfloat16).requires_grad_(True)
    before = window_attention.launches
    out = card(cx)
    out.float().square().mean().backward()
    torch.cuda.synchronize()
    assert window_attention.launches == before + 3
    ref = ref.detach()
    assert float((out.detach().float().cpu() - ref).abs().max()
                 / ref.abs().max()) < 5e-2
    # each leaf against the larger of its norm and the median leaf's (a
    # conv bias in front of a BN has a gradient of round-off alone)
    med = float(torch.tensor([float(g.norm()) for g in
                              ref_grads.values()]).median())
    for k, p in card.named_parameters():
        want = ref_grads[k]
        assert float((p.grad.cpu() - want).norm()) < 5e-2 * max(
            float(want.norm()), med), k
