"""HRFormer on the port (`models/pose_hrformer.py`, the window attention of
`ops/cuda/window_attention.py`, AdamW) against the plain reference
`portbench/reference/pose_hrformer.py`, on the CPU at a tiny size: two
branches of 8 and 16 channels, 7x7 windows on 16x16 and 8x8 maps (neither a
multiple of 7, so every block pads), drop path 0.3.

Tolerances, all in f32 on the CPU:
- forward, 1e-5 of the output's range: the same f32 arithmetic in another
  order (the port scales q k^T, the reference q; the port pads with the
  bias, the reference projects zeros);
- gradients, 1e-4 of the larger of a leaf's norm and the median leaf's
  (a conv bias in front of a BatchNorm has a gradient of round-off alone,
  ~1e-7 against ~1e-1), and the input gradient 1e-4 of its range: the
  backward sums ~10 layers' round-off;
- the plain window attention against the reference's explicit one, 1e-5
  of the range, the bias table's and the projection bias's gradients
  included.
HRNet-W32's state names, seeded initial state and seeded outputs are
pinned to their values before HRNet's code was shared with HRFormer.
"""

from __future__ import annotations

import copy
import hashlib
import os

import pytest
import torch

from advmix_tpu_torch.config import get_default_config, load_config
from advmix_tpu_torch.engine import optim
from advmix_tpu_torch.engine.state import create_advmix_state
from advmix_tpu_torch.engine.steps import graph_key, make_advmix_step, \
    make_capturable_
from advmix_tpu_torch.models import get_pose_net, he_reinit_convs
from advmix_tpu_torch.models import layers
from advmix_tpu_torch.models.unet import UnetGenerator
from advmix_tpu_torch.ops.cuda import window_attention as wa
from portbench import inputs
from portbench.reference import models as ref_models
from portbench.reference import pose_hrformer as ref_hrf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "experiments/synthetic/hrformer_64x64_smoke.yaml")
HRFORMER_B = os.path.join(ROOT,
                          "experiments/coco/hrformer/hrformer_b_256x192_advmix"
                          ".yaml")
W32 = os.path.join(ROOT, "experiments/coco/hrnet/w32_256x192_advmix.yaml")
torch.set_num_threads(2)


def tiny_extra(rate: float = 0.3) -> dict:
    blocks = {"NUM_BRANCHES": 2, "BLOCK": "HRFORMERBLOCK",
              "NUM_CHANNELS": [8, 16], "NUM_HEADS": [2, 4],
              "WINDOW_SIZES": [7, 7], "MLP_RATIOS": [2, 2]}
    return {"FINAL_CONV_KERNEL": 1, "DROP_PATH_RATE": rate,
            "STAGE1": {"NUM_MODULES": 1, "NUM_BRANCHES": 1,
                       "BLOCK": "BOTTLENECK", "NUM_BLOCKS": [1],
                       "NUM_CHANNELS": [64]},
            "STAGE2": dict(blocks, NUM_MODULES=1, NUM_BLOCKS=[2, 2]),
            "STAGE3": dict(blocks, NUM_MODULES=2, NUM_BLOCKS=[1, 1]),
            "STAGE4": dict(blocks, NUM_MODULES=1, NUM_BLOCKS=[1, 1])}


def tiny_cfg(rate: float = 0.3):
    cfg = get_default_config()
    cfg.MODEL.NAME = "pose_hrformer"
    cfg.MODEL.NUM_JOINTS = 5
    cfg.MODEL.IMAGE_SIZE = [64, 64]
    cfg.MODEL.HEATMAP_SIZE = [16, 16]
    cfg.MODEL.EXTRA.update(copy.deepcopy(tiny_extra(rate)))
    cfg.TRAIN.OPTIMIZER = "adamw"
    cfg.TRAIN.LR = 5e-4
    cfg.TRAIN.WD = 0.01
    return cfg


def seeded_pair(rate: float = 0.3):
    """The reference with seeded weights (the benchmark's `he_init_`) and
    the port's model holding the same state."""
    ref = ref_models.pose_net({"NAME": "pose_hrformer", "NUM_JOINTS": 5,
                               "EXTRA": tiny_extra(rate)})
    inputs.he_init_(ref, torch.Generator().manual_seed(1),
                    torch.Generator().manual_seed(2))
    prog = get_pose_net(tiny_cfg(rate))
    prog.load_state_dict(ref.state_dict(), strict=True)
    return prog, ref


def rel(a, b) -> float:
    a, b = a.detach(), b.detach()
    return float((a - b).abs().max() / b.abs().max())


def test_state_names_match_the_reference_and_the_published_layout():
    prog, ref = seeded_pair()
    assert list(prog.state_dict()) == list(ref.state_dict())
    names = set(prog.state_dict())
    for k in ("stage2.0.branches.0.1.attn.attn.qkv.weight",
              "stage2.0.branches.1.0.attn.attn.relative_position_bias_table",
              "stage2.0.branches.1.0.attn.attn.relative_position_index",
              "stage3.1.branches.0.0.ffn.dw3x3.weight",
              "stage3.0.fuse_layers.1.0.0.2.weight", "drop_path_step",
              "drop_path_threshold", "final_layer.weight"):
        assert k in names, k
    # the last module fuses into branch 0 only
    assert not any(k.startswith("stage4.0.fuse_layers.1") for k in names)


def test_hrformer_b_has_the_published_size():
    model = get_pose_net(load_config(HRFORMER_B))
    n = sum(p.numel() for p in model.parameters())
    assert abs(n - 43.2e6) < 0.05e6, n
    blocks = [m for m in model.modules()
              if type(m).__name__ == "HRFormerBlock"]
    assert len(blocks) == 44
    rates = sorted({m.drop_path.rate for m in blocks})
    assert rates[0] == 0.0 and rates[-1] == pytest.approx(0.2)
    assert len(rates) == 14  # linspace over 2 + 8 + 4 block depths


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_hrformer_matches_reference(mode):
    prog, ref = seeded_pair()
    x = torch.randn(3, 3, 64, 64, generator=torch.Generator().manual_seed(3))
    g = torch.randn(3, 5, 16, 16, generator=torch.Generator().manual_seed(4))
    outs = []
    for m in (ref, prog):
        m.train(mode == "train")
        xi = x.clone().requires_grad_(True)
        y = m(xi)
        (y * g).sum().backward()
        outs.append((y.detach(), xi.grad))
    (yr, dxr), (yp, dxp) = outs
    assert rel(yp, yr) < 1e-5
    assert rel(dxp, dxr) < 1e-4
    grads = {k: p.grad for k, p in ref.named_parameters()}
    med = float(torch.tensor([float(v.norm()) for v in grads.values()])
                .median())
    for k, p in prog.named_parameters():
        want = grads[k]
        assert float((p.grad - want).norm()) <= 1e-4 * max(
            float(want.norm()), med), k
    if mode == "train":
        assert int(prog.drop_path_step) == int(ref.drop_path_step) == 1
        for a, b in zip(prog.buffers(), ref.buffers()):
            assert torch.allclose(a.double(), b.double(), rtol=1e-5,
                                  atol=1e-6)


def test_drop_path_masks_match_and_change_every_step():
    prog, ref = seeded_pair(0.3)
    thr = prog.drop_path_threshold
    assert torch.equal(thr, ref.drop_path_threshold)
    masks = []
    for step in range(4):
        s = torch.tensor(step, dtype=torch.int64)
        mine = layers.drop_path_scales(s, thr, 64)
        theirs = ref_hrf.drop_masks(s, thr, 64)
        assert torch.equal(mine, theirs)
        masks.append(mine)
    for a, b in zip(masks, masks[1:]):
        assert not torch.equal(a, b)
    live = thr > 0
    # rate-0 slots keep every sample at factor 1; the others drop some
    assert torch.equal(masks[0][~live], torch.ones_like(masks[0][~live]))
    kept = torch.stack(masks)[:, live] > 0
    want = 1.0 - thr[live].double() / 2 ** 24
    got = kept.double().mean(dim=(0, 2))
    assert float((got - want).abs().max()) < 0.15
    # a kept sample is scaled by the inverse of its keep rate
    scale = torch.stack(masks)[:, live].amax(dim=(0, 2)).double()
    assert torch.allclose(scale, 1.0 / want, rtol=1e-6)


def test_drop_path_counter_advances_in_train_mode_only():
    prog, _ = seeded_pair()
    x = torch.randn(2, 3, 64, 64)
    prog.eval()
    with torch.no_grad():
        prog(x)
    assert int(prog.drop_path_step) == 0
    prog.train()
    with torch.no_grad():
        prog(x)
        prog(x)
    assert int(prog.drop_path_step) == 2
    assert all(m.scales is None for m in prog.modules()
               if isinstance(m, layers.DropPath))


@pytest.mark.parametrize("shape", [(2, 16, 16, 8, 2), (3, 9, 11, 24, 3),
                                   (1, 7, 14, 16, 4), (2, 3, 5, 12, 1)])
def test_plain_window_attention_matches_reference(shape):
    """`window_attention` (the plain version, through the custom op and
    its autograd) against the reference's explicit pad, partition,
    projection and softmax, forward and every gradient."""
    b, h, w, c, heads = shape
    gen = torch.Generator().manual_seed(sum(shape))
    ref = ref_hrf.LocalWindowSelfAttention(c, heads, 7)
    with torch.no_grad():
        for p in ref.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.5)
    x = torch.randn(b, h * w, c, generator=gen)
    gy = torch.randn(b, h * w, c, generator=gen)
    xr = x.clone().requires_grad_(True)
    (ref(xr, h, w) * gy).sum().backward()
    a = ref.attn
    xp = x.clone().view(b, h, w, c).requires_grad_(True)
    qkv_w = a.qkv.weight.detach().clone().requires_grad_(True)
    qkv_b = a.qkv.bias.detach().clone().requires_grad_(True)
    table = a.relative_position_bias_table.detach().clone().requires_grad_(
        True)
    qkv = torch.nn.functional.linear(xp, qkv_w, qkv_b)
    out = wa.window_attention(qkv, qkv_b, table, heads, 7)
    y = torch.nn.functional.linear(out, a.proj.weight, a.proj.bias)
    (y.reshape(b, h * w, c) * gy).sum().backward()
    assert rel(y.reshape(b, h * w, c), ref(x, h, w).detach()) < 1e-5
    assert rel(xp.grad.reshape(b, h * w, c), xr.grad) < 1e-5
    assert rel(qkv_w.grad, a.qkv.weight.grad) < 1e-5
    assert rel(qkv_b.grad, a.qkv.bias.grad) < 1e-5
    assert rel(table.grad, a.relative_position_bias_table.grad) < 1e-5
    assert torch.equal(a.relative_position_index,
                       wa.relative_position_index(7))


def test_window_attention_ops_check():
    """The custom ops' schemas, fake implementations and CPU kernels agree
    (`torch.library.opcheck`), and a CUDA-less call never launches."""
    gen = torch.Generator().manual_seed(0)
    qkv = torch.randn(2, 9, 10, 3 * 12, generator=gen)
    bias = torch.randn(36, generator=gen)
    table = torch.randn(169, 3, generator=gen)
    before = wa.window_attention.launches
    torch.library.opcheck(torch.ops.advmix_tpu_torch.window_attn,
                          (qkv, bias, table, 3, 7))
    out, lse = torch.ops.advmix_tpu_torch.window_attn(qkv, bias, table, 3, 7)
    assert lse.shape == (2 * 2 * 2, 3, 49)
    dout = torch.randn(out.shape, generator=gen)
    torch.library.opcheck(torch.ops.advmix_tpu_torch.window_attn_backward,
                          (dout, qkv, bias, table, lse, 3, 7))
    assert wa.window_attention.launches == before


# (H, W, C, heads): HRFormer-B's four branches, and the card tests' small
# maps and odd C
@pytest.mark.parametrize("shape", [(64, 48, 78, 2), (32, 24, 156, 4),
                                   (16, 12, 312, 8), (8, 6, 624, 16),
                                   (9, 11, 24, 3), (5, 3, 96, 3),
                                   (14, 7, 64, 2), (7, 9, 39, 1)])
def test_window_attention_route_and_head_group(shape):
    """f32 takes the simt kernels, bf16 the tensor-core ones, a head a
    block, whose token runs fit the kernels' 40 elements; at batch 32 and
    any residency the card may report, the mma grid walks each window
    once, with at least one block a head and no more than its share of
    the resident blocks."""
    h, w, c, heads = shape
    assert wa.kernel_route(torch.float32) == "simt"
    assert wa.kernel_route(torch.bfloat16) == "mma"
    assert c % heads == 0 and c // heads <= wa.MAX_HEAD_DIM
    nh, nw = wa.num_windows(h, w, 7)
    windows = 32 * nh * nw
    for resident in (1, 7, 132 * 3, 132 * 4, 132 * 5):
        blocks = wa.mma_blocks(windows, heads, resident)
        assert 1 <= blocks <= windows
        assert blocks <= max(1, -(-resident // heads))
        walked = sorted(w for x in range(blocks)
                        for w in range(x, windows, blocks))
        assert walked == list(range(windows))


def test_window_attention_kernel_limits_raise_on_a_card_only():
    with pytest.raises(ValueError):
        wa.window_attention(torch.zeros(1, 4, 4, 12, device="meta"), None,
                            torch.zeros(169, 2), 2, 7)


@pytest.mark.parametrize("steps", [1, 3])
def test_adamw_equals_torch_adamw(steps):
    cfg = tiny_cfg()
    torch.manual_seed(0)
    a = torch.nn.Linear(6, 4)
    b = copy.deepcopy(a)
    opt = optim.get_optimizer(cfg, a.parameters())
    assert isinstance(opt, torch.optim.AdamW)
    ref = torch.optim.AdamW(b.parameters(), lr=5e-4, weight_decay=0.01,
                            foreach=False)
    for i in range(steps):
        x = torch.randn(5, 6, generator=torch.Generator().manual_seed(i))
        for m, o in ((a, opt), (b, ref)):
            o.zero_grad()
            m(x).square().sum().backward()
            o.step()
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.allclose(p, q, rtol=1e-6, atol=1e-7)
    # the graph path's hooks: capturable set, hyper-parameters in the key
    make_capturable_([opt])
    assert opt.param_groups[0]["capturable"]
    batch = {k: torch.zeros(1) for k in ("views", "target",
                                         "target_weight")}
    assert ("weight_decay", 0.01) in graph_key(batch, [opt])[1][0]


def test_set_compute_dtype_casts_linears_of_a_frozen_teacher():
    prog, _ = seeded_pair()
    cfg = tiny_cfg()
    state = create_advmix_state(
        cfg, prog, UnetGenerator(input_nc=9, output_nc=3, num_downs=6,
                                 ngf=8), torch.device("cpu"), torch.bfloat16)
    t = state.teacher
    lin = [m for m in t.modules() if isinstance(m, torch.nn.Linear)]
    assert lin and all(m.weight.dtype == torch.bfloat16
                       and m.bias.dtype == torch.bfloat16 for m in lin)
    assert all(m.weight.dtype == torch.float32 for m in t.modules()
               if isinstance(m, torch.nn.LayerNorm))
    assert all(p.dtype == torch.float32 for n, p in t.named_parameters()
               if n.endswith("relative_position_bias_table"))
    assert not any(p.requires_grad for p in t.parameters())
    with torch.no_grad():
        y = t(torch.randn(2, 3, 64, 64))
    assert y.dtype == torch.float32 and torch.isfinite(y).all()
    # D under training keeps f32 masters, linears included
    assert all(p.dtype == torch.float32
               for p in state.model_d.parameters())


def test_advmix_step_trains_hrformer_on_adamw():
    """Two eager AdvMix iterations of the bf16 HRFormer on the CPU: both
    optimizers AdamW, every trained leaf moved, D's counter two a step."""
    prog, _ = seeded_pair()
    cfg = tiny_cfg()
    g = UnetGenerator(input_nc=9, output_nc=3, num_downs=6, ngf=8)
    state = create_advmix_state(cfg, prog, g, torch.device("cpu"),
                                torch.bfloat16)
    assert isinstance(state.optimizer_g, torch.optim.AdamW)
    step = make_advmix_step(state, cfg)
    start = {k: v.clone() for k, v in state.model_d.named_parameters()}
    gen = torch.Generator().manual_seed(5)
    for _ in range(2):
        batch = {"views": torch.randn(2, 9, 64, 64, generator=gen),
                 "target": torch.rand(2, 5, 16, 16, generator=gen),
                 "target_weight": torch.ones(2, 5)}
        metrics = step(batch)
    assert all(torch.isfinite(v).all() for v in metrics.values())
    assert int(state.model_d.drop_path_step) == 4
    moved = [k for k, v in state.model_d.named_parameters()
             if not torch.equal(v, start[k])]
    assert len(moved) == len(start)


def test_train_tool_runs_hrformer_advmix(tmp_path, monkeypatch):
    from advmix_tpu_torch.tools import train as train_tool

    monkeypatch.chdir(tmp_path)
    out = train_tool.main(["--cfg", SMOKE, "--device", "cpu", "--advmix",
                           "--sample_times", "3", "--downsamples", "4",
                           "DATASET.SYNTH_LENGTH", "16", "PRINT_FREQ", "1"])
    state = out["state"]
    assert state.step == 2
    assert isinstance(state.optimizer_d, torch.optim.AdamW)
    assert int(state.model_d.drop_path_step) == 4


# HRNet-W32 before HRFormer shared its code: the sha256 of its state names
# and shapes, of its seeded initial state (`get_pose_net`), and its eval
# output on a seeded input after `he_reinit_convs`
W32_NAMES = "dcdc28ab35db79a5dc2d020e19ccdfd2c8808582c9942767f37348dc209ba35d"
W32_INIT = "ea591e68f3969864f7a326719c05bca539c489f6efc4fd5db75ec4cfaf2571c5"
W32_OUT_SUM, W32_OUT_ABS = -21570373358.64453, 1072108766079.0117


def test_w32_names_state_and_outputs_unchanged_by_the_factoring():
    torch.manual_seed(0)
    m = get_pose_net(load_config(W32))
    sd = m.state_dict()
    names = "\n".join(f"{k}:{tuple(v.shape)}" for k, v in sd.items())
    assert hashlib.sha256(names.encode()).hexdigest() == W32_NAMES
    assert len(sd) == 1754
    init = b"".join(v.numpy().tobytes() for v in sd.values()
                    if v.dtype.is_floating_point)
    assert hashlib.sha256(init).hexdigest() == W32_INIT
    he_reinit_convs(m, torch.Generator().manual_seed(3))
    m.eval()
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        y = m(x).double()
    assert float(y.sum()) == pytest.approx(W32_OUT_SUM, rel=1e-6)
    assert float(y.abs().sum()) == pytest.approx(W32_OUT_ABS, rel=1e-6)


def test_two_gloo_ranks_match_the_data_parallel_reference():
    """The several-rank kind (`portbench/kinds/advmix_train_dp.py`) at
    a tiny size on two gloo ranks of the CPU: rank 0 in this process, rank
    1 spawned, the program's eager AdvMix step with its all-reduces against
    `portbench/reference/train_dp.py`, both in float64 (the check's
    witness mode), so that the two agree to 1e-9: in f32 the ranks' sums
    in another order move near-zero gradients that Adam's first step
    scales to a full step, by ~1% at this size."""
    import dataclasses

    from portbench import core
    from portbench.kinds import advmix_train_dp
    from portbench.tests.tiny import tiny_cell

    base = tiny_cell("w32-advmix-b32")
    cell = dataclasses.replace(
        base, name="w32-advmix-dp2", chips=2,
        traffic=dict(base.traffic, kind="advmix_train_dp", ranks=2, batch=2,
                     first_steps=2, warm_steps=1))
    ctx = core.Context(cell=cell, cfg=core.port_config(cell.config),
                       seed=2 ** 31 + 17, device=torch.device("cpu"),
                       float64=True)
    work = advmix_train_dp.CellRun(ctx)
    work.setup()
    work.iteration(work.k, False)
    work.release()
    assert work.k == 4 and not work.procs[0].is_alive()
    assert work.procs[0].exitcode == 0
    numbers = work.check()
    assert max(numbers.values()) < 1e-9, numbers
    assert work.end_to_end([0.5], 1.0)["train_img_s"] == 4.0


def test_window_attention_bytes_and_readers():
    """The HRFormer cell's least bytes an iteration, worked by hand, and
    the three new readers on a hand-made trace (nothing where the trace
    holds nothing for them)."""
    import json

    from portbench import trace
    from portbench.kinds.advmix_train_attn import window_attn_bytes
    from portbench.metrics import (allreduce_ms, window_attn_device_ms,
                                   window_attn_roofline)

    with open(os.path.join(ROOT, "portbench/configs/hrformer-b-256x192.json")
              ) as f:
        model = json.load(f)["yaml"]["MODEL"]
    # per branch (tokens a card, C, heads, block calls a forward): 3
    # forwards of 4 T C 2 bytes and 2 backwards of 7 T C 2 + 4 T heads
    want = 0
    for t, c, heads, calls in ((32 * 64 * 48, 78, 2, 14),
                               (32 * 32 * 24, 156, 4, 14),
                               (32 * 16 * 12, 312, 8, 12),
                               (32 * 8 * 6, 624, 16, 4)):
        want += calls * (3 * 8 * t * c + 2 * (14 * t * c + 4 * t * heads))
    assert window_attn_bytes(model, 32, (192, 256)) == want == 9807200256

    op = trace.DeviceOp
    t = trace.Trace(iters=[(0, 1000), (1000, 2000)], spans={}, ops=[
        op("void window_attn_fwd_kernel<bf16, 40>", "kernel", 0, 100, None),
        op("void window_attn_bwd_kernel<bf16, 40>", "kernel", 200, 500,
           None),
        op("ncclDevKernel_AllReduce_Sum_f32", "kernel", 600, 700, None,
           650),
        op("void conv", "kernel", 1000, 1900, None)])
    assert window_attn_device_ms.read(t) == pytest.approx(200e-6)
    assert window_attn_roofline.read(t) is None  # no bytes handed over
    t.extra = {"window_attn_bytes": 3.35e12 * 1e-7}
    assert window_attn_roofline.read(t) == pytest.approx(50.0)
    assert allreduce_ms.read(t) is None
    t.program_spans = {"advmix.all_reduce": [(640, 660)]}
    assert allreduce_ms.read(t) == pytest.approx(50e-6)
    t.ops = t.ops[-1:]
    assert window_attn_device_ms.read(t) is None
