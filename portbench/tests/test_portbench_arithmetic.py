"""The yardstick's arithmetic on hand-worked numbers: FLOPs, bytes, the
shares of peaks and rooflines, percentiles, the worst-leaf gap, and the
trace's busy time, idle gaps and per-span device time."""

from __future__ import annotations

import math

import pytest
import torch

from portbench import core, flops, trace
from portbench.metrics import _per_iter
from portbench.reference import train


def test_conv_flops_are_two_per_multiply_add():
    with torch.device("meta"):
        c = torch.nn.Conv2d(3, 8, 3, padding=1, bias=False)
        x = torch.empty(2, 3, 10, 10)
    n = flops._count(lambda: c(x))
    assert n == 2 * (2 * 8 * 10 * 10) * (3 * 3 * 3)


def test_input_gradient_counts_no_weight_gradient():
    with torch.device("meta"):
        c = torch.nn.Conv2d(3, 8, 3, padding=1, bias=False)
        x = torch.empty(1, 3, 10, 10, requires_grad=True)

    def run():
        torch.autograd.backward(c(x).sum(), inputs=[x])

    # forward plus the input gradient: two convolutions' worth
    assert flops._count(run) == 2 * 2 * (8 * 10 * 10) * 27


def test_w32_forward_flops():
    model = core.load_json(core.HERE, "configs",
                           "hrnet-w32-256x192.json")["yaml"]["MODEL"]
    # 2 x 7.645 GMAC per 256x192 image (HRNet's table: 7.1 GFLOPs, which
    # leaves out the fuse layers' upsampling 1x1 convs' share)
    assert flops.eval_batch_flops(model, 1, (192, 256)) == 2 * 15290007552


def test_decode_bytes():
    assert flops.decode_bytes(128, 17, 64, 48) == \
        128 * 17 * (64 * 48 * 4 + 12)


def test_shares_of_peaks():
    assert flops.mfu_pct(989e12, 1.0) == pytest.approx(100.0)
    assert flops.mfu_pct(9.89e12, 2.0) == pytest.approx(0.5)
    # 3.35 GB at 3.35 TB/s is 1 ms: 1 ms of kernel time is 100%
    assert flops.hbm_roofline_pct(3.35e9, 1e-3) == pytest.approx(100.0)
    assert flops.hbm_roofline_pct(3.35e9, 4e-3) == pytest.approx(25.0)


def test_percentile_inclusive():
    v = list(range(1, 102))  # 1..101
    assert core.percentile(v, 90) == pytest.approx(91.0)
    assert core.percentile(v, 95) == pytest.approx(96.0)


def test_leaf_gaps_use_the_median_floor():
    def t(*v):
        return torch.tensor(v, dtype=torch.float64)

    ref = {"a": t(1.0), "b": t(0.0, 2.0), "c": t(3.0), "tiny": t(1e-6)}
    prog = {"a": t(1.1), "b": t(2.0, 0.0), "c": t(3.0), "tiny": t(2e-6)}
    # median of the ref norms is 1.5; a: 0.1 / 1.5; tiny: 1e-6 / 1.5
    n = train.leaf_numbers(prog, ref)
    gaps = n["gap"]
    assert gaps["a"] == pytest.approx(0.1 / 1.5)
    assert gaps["tiny"] == pytest.approx(1e-6 / 1.5)
    assert train.median(list(gaps.values())) == pytest.approx(1e-6 / 3.0)
    # b's norm is right, its elements are not: only "diff" sees it
    assert gaps["b"] == 0.0
    assert n["diff"]["b"] == pytest.approx(8 ** 0.5 / 2.0)
    kept = train.leaf_numbers(prog, ref, keep={"a", "c"})
    assert set(kept["gap"]) == {"a", "c"} and kept["den_median"] == 2.0
    assert train.moving_leaves({"a": t(1.0), "b": t(1.0), "z": t(1e-4)}) \
        == {"a", "b"}
    unchanged = train.leaf_numbers({k: 0 * v for k, v in ref.items()}, ref)
    assert max(unchanged["gap"].values()) == pytest.approx(1.0)
    assert max(unchanged["diff"].values()) == pytest.approx(1.0)


def test_mix_diff_reads_missing_rows_as_the_uniform_mix():
    g = torch.Generator().manual_seed(0)
    ref = torch.softmax(0.1 * torch.randn(4, 3, 5, 6, generator=g), dim=1)
    assert train.mix_diff(ref.clone(), ref) == 0.0
    half = train.mix_diff(ref[:2], ref)
    assert half == pytest.approx(
        float((ref[2:].double() - 1 / 3).norm() / (ref.double() - 1 / 3).norm()))
    assert 0.5 < half < 1.0
    assert train.mix_diff(ref[:, :2], ref) == 1.0


def _op(start, end, span, name="k", kind="kernel"):
    return trace.DeviceOp(name, kind, start, end, span)


def synthetic():
    # two iterations of 100 ns; ops overlap in the second
    ops = [_op(10, 30, "pb.prep"),
           _op(40, 70, "pb.step", "decode_warp"),
           _op(110, 150, "pb.step"),
           _op(140, 160, "pb.step", kind="gpu_memcpy")]
    return trace.Trace(iters=[(0, 100), (100, 200)],
                       spans={"pb.to_device": [(0, 5), (100, 105)],
                              "pb.prep": [(5, 20), (105, 110)],
                              "pb.step": [(20, 60), (110, 130)],
                              "pb.sync": [(60, 100), (130, 200)]},
                       ops=ops)


def test_trace_busy_idle_and_spans():
    t = synthetic()
    assert t.window_s == pytest.approx(200e-9)
    assert t.busy_s() == pytest.approx((20 + 30 + 50) * 1e-9)
    assert _per_iter.idle_pct(t) == pytest.approx(50.0)
    assert t.device_s_in("pb.step") == pytest.approx(90e-9)
    assert t.gaps() == [(0, 10), (30, 40), (70, 110), (160, 200)]
    assert t.span_at(75) == "pb.sync"
    assert len(t.kernels()) == 3
    bd = t.breakdown()
    assert bd["idle_gaps"][0] == ["pb.sync", pytest.approx(40e-9)]
    assert len(bd["device_ops"]) <= 10


def test_readers_on_the_synthetic_trace():
    from portbench.metrics import (advmix_step_device_ms, decode_roofline,
                                   train_host_ms, train_launches_per_iter,
                                   train_mfu)

    t = synthetic()
    assert advmix_step_device_ms.read(t) == pytest.approx(45e-6)
    assert train_host_ms.read(t) == pytest.approx((5 + 15 + 40 + 5 + 5 + 20)
                                                  / 2 * 1e-6)
    assert train_launches_per_iter.read(t) == 1.5
    assert train_mfu.read(t) is None  # no untraced iterations
    t.iter_s, t.flops_per_iter = [0.5, 0.5], 989e12 * 0.01
    assert train_mfu.read(t) == pytest.approx(2.0)  # 1% of a second in 0.5 s
    assert decode_roofline.read(t) is None  # no byte count given
    t.extra["decode_bytes"] = 3.35e12 * 15e-9
    assert decode_roofline.read(t) == pytest.approx(50.0)


def test_finite():
    assert core.finite(1.0) and not core.finite(math.nan)
    assert not core.finite(None)


class _Event:
    """A profiler event of a torch that names no activity kind."""

    def __init__(self, name, device):
        self._name, self._device = name, device

    def name(self):
        return self._name

    def device_type(self):
        return self._device


@pytest.mark.parametrize("name,device,kind", [
    ("pb.step", "DeviceType.CPU", "user_annotation"),
    ("pb.step", "DeviceType.CUDA", "gpu_user_annotation"),
    ("cudaLaunchKernel", "DeviceType.CPU", "cuda_runtime"),
    ("cuLaunchKernelEx", "DeviceType.CPU", "cuda_runtime"),
    ("cudnn::convolution", "DeviceType.CPU", "cpu_op"),
    ("aten::add", "DeviceType.CPU", "cpu_op"),
    ("Memcpy HtoD (Pinned -> Device)", "DeviceType.CUDA", "gpu_memcpy"),
    ("Memset (Device)", "DeviceType.CUDA", "gpu_memset"),
    ("decode_warp_kernel", "DeviceType.CUDA", "kernel")])
def test_event_kind_without_activity_type(name, device, kind):
    assert trace._kind(_Event(name, device)) == kind


def test_device_copy_of_a_host_range_is_no_kernel():
    e = _Event("Optimizer.step#Adam.step", "DeviceType.CUDA")
    assert trace._kind(e) == "kernel"
    assert trace._kind(e, frozenset({"Optimizer.step#Adam.step"})) == \
        "gpu_user_annotation"
