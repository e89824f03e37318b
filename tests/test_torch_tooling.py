"""The port's tooling: utils/profiling.py, utils/summary.py and the tools
profile, hbm_peak, loader_bench and parity_check, on the CPU at small sizes.

- `trace` as tests/test_misc_paths.py:113 holds the JAX one, and it
  writes a Chrome trace;
- `analyze_kernels` and `analyze_trace` on a written Chrome trace, as
  tests/test_misc_paths.py:173 holds the JAX `analyze_kernels`: per-kernel
  sums over steps, an operator's bytes and FLOPs charged once to its first
  kernel (through the enclosing operator that counts FLOPs), the
  max(bytes, FLOPs) speed of light, no roofline without a measured peak;
- `tools/profile` on the synthetic smoke YAML (two ranks: the by-phase
  table holds rank 0's collectives; AdvMix: the step's phases; `--eval`
  with a corruption: the eval phases, no constant built) and on a
  narrowed HigherHRNet AdvMix config with `--device cpu`, as
  tests/test_scripts.py:293,316 run the JAX tool;
- `model_summary`'s parameter and BN-statistic counts equal the JAX
  `model_summary`'s exactly; its FLOPs (FlopCounterMode: every tap of each
  window, nothing elementwise) within 8% above XLA's at 256x256 (measured:
  1.064x for PoseResNet-18; XLA skips the taps on the zero padding);
- `tools/hbm_peak` and `tools/loader_bench` at tiny sizes;
- `tools/parity_check`'s three contracts, as tests/test_parity_check.py
  (its slow case marked slow here too), and a JAX `final_state` directory
  stopping the run.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advmix_tpu.models.pose_resnet import PoseResNet as JaxPoseResNet
from advmix_tpu.utils.summary import model_summary as jax_model_summary
from advmix_tpu_torch.models import get_pose_net
from advmix_tpu_torch.tools import hbm_peak, loader_bench, parity_check
from advmix_tpu_torch.tools import profile as profile_tool
from advmix_tpu_torch.utils.profiling import by_family, family_of, trace
from advmix_tpu_torch.utils.summary import format_summary, model_summary, \
    per_layer_summary

from test_torch_spatial import resnet_cfg
from torch_dist_worker import rank_sys_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE_CFG = os.path.join(ROOT, "experiments/synthetic/res18_64x64_smoke.yaml")
HIGHER = os.path.join(ROOT, "experiments/coco/higher_hrnet/w32_512_advmix.yaml")
W32 = os.path.join(ROOT, "experiments/coco/hrnet/w32_256x192_advmix.yaml")


def test_step_timer_and_trace(tmp_path):
    x = torch.ones(8, 8)
    with trace(str(tmp_path / "off"), enabled=False) as prof:
        assert prof is None
        torch.mm(x, x)
    assert not (tmp_path / "off").exists()
    with trace(str(tmp_path / "on")):
        torch.mm(x, x)
    events = json.load(open(tmp_path / "on" / "trace.json"))["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def test_kernel_families():
    assert family_of("cudnn_batch_norm_fwd") == "batch norm"
    assert family_of("sm90_xmma_fprop_implicit_gemm") == "conv/gemm"
    assert family_of("void at::native::vectorized_elementwise_kernel") == \
        "elementwise"
    assert family_of("decode_warp_kernel") == "other"
    assert by_family({"a_gemm": (3.0, 1), "b_conv": (2.0, 2),
                      "x": (9.0, 1)}) == {"other": (9.0, 1),
                                           "conv/gemm": (5.0, 3)}


def _write_trace(d):
    """Two steps: conv2d (a FLOP count) launching through an inner
    cudnn_convolution one conv kernel and one cast, twice per step; one
    elementwise add per step (bytes only)."""
    ev, ext = [], 0
    for step in range(2):
        for rep in range(2):
            ts = 1000 * step + 100 * rep
            ext += 1
            ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::conv2d",
                       "ts": ts, "dur": 50, "tid": 1,
                       "args": {"External id": ext, "flops": 10**9,
                                "Input Dims": [[2, 8, 64, 64],
                                               [16, 8, 3, 3], []],
                                "Input type": ["float", "float", ""]}})
            ext += 1
            ev.append({"ph": "X", "cat": "cpu_op",
                       "name": "aten::cudnn_convolution", "ts": ts + 5,
                       "dur": 40, "tid": 1,
                       "args": {"External id": ext,
                                "Input Dims": [[1], [1]],
                                "Input type": ["float", "float"]}})
            for name, dur in (("sm90_xmma_fprop_kernel", 500.0),
                              ("cast_copy_kernel", 20.0)):
                ev.append({"ph": "X", "cat": "kernel", "name": name,
                           "ts": ts + 10, "dur": dur,
                           "args": {"External id": ext}})
        ext += 1
        ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::add",
                   "ts": 1000 * step + 500, "dur": 5, "tid": 1,
                   "args": {"External id": ext,
                            "Input Dims": [[250, 1000, 1000], [250, 1000,
                                                               1000]],
                            "Input type": ["float", "float"]}})
        ev.append({"ph": "X", "cat": "kernel",
                   "name": "vectorized_elementwise_kernel",
                   "ts": 1000 * step + 501, "dur": 2000.0,
                   "args": {"External id": ext}})
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "trace.json"), "w") as f:
        json.dump({"traceEvents": ev}, f)


def test_analyze_kernels_math(tmp_path):
    _write_trace(str(tmp_path))
    rows = profile_tool.analyze_kernels(str(tmp_path), n_steps=2,
                                        peak_gbs=500.0, peak_tflops=200.0)
    by = {r[0]: r for r in rows}
    _, t_ms, gb, gfl, sol, cnt = by["sm90_xmma_fprop_kernel"]
    assert abs(t_ms - 1.0) < 1e-9  # 2 launches per step x 500 us
    assert cnt == 2
    # conv2d's inputs (2*8*64*64 + 16*8*9 floats) and FLOPs, twice a step
    assert abs(gb - 2 * (2 * 8 * 64 * 64 + 16 * 8 * 9) * 4 / 1e9) < 1e-12
    assert abs(gfl - 2.0) < 1e-9
    assert abs(sol - 2.0 / (200.0 * 1e3) * 1e3) < 1e-12  # FLOPs-bound
    # the cast kernel of the same operator is charged nothing
    assert by["cast_copy_kernel"][2:4] == (0.0, 0.0)
    _, t_ms, gb, gfl, sol, cnt = by["vectorized_elementwise_kernel"]
    assert abs(gb - 2.0) < 1e-9 and gfl == 0.0
    assert abs(sol - 2.0 / 500.0 * 1e3) < 1e-9  # bytes-bound
    assert rows[0][0] == "vectorized_elementwise_kernel"  # costliest first
    # no measured bandwidth: no roofline
    assert all(r[4] is None for r in
               profile_tool.analyze_kernels(str(tmp_path), n_steps=2))
    fams = dict((f, (t, n)) for f, t, n in
                profile_tool.analyze_trace(str(tmp_path), 2))
    assert fams["conv/gemm"] == (1.0, 2.0)
    assert fams["elementwise"] == (2.0, 1.0)


def test_peak_gbs_reads_hbm_peak_json(tmp_path):
    p = tmp_path / "hbm.json"
    p.write_text("=> device: x\n" + json.dumps(
        {"device": "x", "measured_peak_gbs": 2990.5, "scale": 1.0}) + "\n")
    assert profile_tool.peak_gbs_of(str(p)) == 2990.5
    assert profile_tool.peak_gbs_of("1234.5") == 1234.5
    assert profile_tool.peak_gbs_of(None) is None


def test_profile_cli_top_down_two_ranks(tmp_path, capsys):
    with rank_sys_path():
        out = profile_tool.main([
            "--profile_steps", "2", "--trace_dir", str(tmp_path / "trace"),
            "--per_kernel", "3", "--cfg", SMOKE_CFG, "--device", "cpu",
            "--num_devices", "2", "TRAIN.BATCH_SIZE_PER_GPU", "4",
            "OUTPUT_DIR", str(tmp_path)])
    assert np.isfinite(out["metrics"]["loss"])
    assert (tmp_path / "trace" / "trace.json").is_file()
    # rank 0's collectives: the gradients', the BN statistics', PCK's and
    # the loss's means, one span and one count event a collective
    phases = {r[0]: r for r in out["phases"]}
    assert {"advmix.train_prep", "advmix.all_reduce",
            "advmix.count.all_reduce"} <= set(phases)
    assert phases["advmix.all_reduce"][1] >= 4
    assert phases["advmix.count.all_reduce"][1] \
        == phases["advmix.all_reduce"][1]
    assert phases["advmix.all_reduce"][3] is None  # no device on the CPU


def test_profile_cli_top_down_advmix_phases(tmp_path, capsys):
    out = profile_tool.main([
        "--profile_steps", "2", "--trace_dir", str(tmp_path / "trace"),
        "--cfg", SMOKE_CFG, "--advmix", "--sample_times", "3",
        "--device", "cpu", "TRAIN.BATCH_SIZE_PER_GPU", "2",
        "OUTPUT_DIR", str(tmp_path)])
    assert "by phase" in capsys.readouterr().out
    assert np.isfinite(out["metrics"]["loss_d"])
    rows = {r[0]: r[1:] for r in out["phases"]}
    # on the CPU every AdvMix call is eager, and counts itself so
    assert list(rows) == ["advmix.train_prep", "advmix.advmix_step",
                          "advmix.count.eager_step",
                          "advmix.generate", "advmix.teacher",
                          "advmix.d_update", "advmix.d_adam",
                          "advmix.g_update", "advmix.g_adam",
                          "advmix.metrics"]
    for name, (calls, host, dev, idle, launches) in rows.items():
        assert calls == 1.0, name
        assert host > 0 or name.startswith("advmix.count."), name
        assert dev is idle is launches is None, name  # host ms only
    parts = sum(rows[k][1] for k in ("advmix.generate", "advmix.teacher",
                                     "advmix.d_update", "advmix.g_update",
                                     "advmix.metrics"))
    assert parts <= rows["advmix.advmix_step"][1]


def test_profile_cli_eval_corrupted_phases(tmp_path, capsys):
    out = profile_tool.main([
        "--eval", "--corruption_type", "defocus_blur", "--severity", "1",
        "--profile_steps", "2", "--trace_dir", str(tmp_path / "trace"),
        "--cfg", SMOKE_CFG, "--device", "cpu", "TEST.BATCH_SIZE_PER_GPU",
        "2", "OUTPUT_DIR", str(tmp_path)])
    printed = capsys.readouterr().out
    assert "eval defocus_blur 1" in printed
    assert "corruption constants built a step: 0.0" in printed
    assert np.isfinite(out["metrics"]["loss"])
    rows = {r[0]: r[1:] for r in out["phases"]}
    # the warm-up built the pass's constants: the profiled steps build none
    assert list(rows) == ["advmix.eval_prep", "advmix.corrupt",
                          "advmix.eval_step", "advmix.eval_forward",
                          "advmix.eval_score", "advmix.eval_decode"]
    assert out["const_builds_per_step"] == 0
    for name, (calls, host, dev, idle, launches) in rows.items():
        assert calls == 1.0 and host > 0, name
        assert dev is idle is launches is None, name  # host ms only
    assert rows["advmix.corrupt"][1] <= rows["advmix.eval_prep"][1]
    parts = sum(rows[k][1] for k in ("advmix.eval_forward",
                                     "advmix.eval_score",
                                     "advmix.eval_decode"))
    assert parts <= rows["advmix.eval_step"][1]


def test_profile_cli_bottomup_advmix(tmp_path, capsys):
    out = profile_tool.main([
        "--profile_steps", "1", "--trace_dir", str(tmp_path / "trace"),
        "--cfg", HIGHER, "--advmix", "--sample_times", "3",
        "--device", "cpu",
        "TRAIN.BATCH_SIZE_PER_GPU", "2", "TRAIN.DTYPE", "float32",
        "MODEL.IMAGE_SIZE", "[64,64]", "MODEL.HEATMAP_SIZE", "[16,16]",
        "MODEL.EXTRA.STAGE2.NUM_BLOCKS", "[1,1]",
        "MODEL.EXTRA.STAGE3.NUM_BLOCKS", "[1,1,1]",
        "MODEL.EXTRA.STAGE4.NUM_BLOCKS", "[1,1,1,1]",
        "MODEL.EXTRA.STAGE3.NUM_MODULES", "1",
        "MODEL.EXTRA.STAGE4.NUM_MODULES", "1",
        "MODEL.EXTRA.STAGE2.NUM_CHANNELS", "[8,16]",
        "MODEL.EXTRA.STAGE3.NUM_CHANNELS", "[8,16,32]",
        "MODEL.EXTRA.STAGE4.NUM_CHANNELS", "[8,16,32,64]",
        "MODEL.EXTRA.NUM_BASIC_BLOCKS", "1",
        "MODEL.EXTRA.DECONV.NUM_CHANNELS", "[8]",
        "OUTPUT_DIR", str(tmp_path)])
    printed = capsys.readouterr().out
    assert "step profile" in printed and "advmix" in printed
    assert "pose_higher_hrnet" in printed
    assert np.isfinite(out["metrics"]["loss_d"])


def test_model_summary_matches_jax():
    jm = JaxPoseResNet(num_layers=18, num_joints=4,
                       num_deconv_filters=(16, 16, 16))
    x = jnp.zeros((2, 256, 256, 3))
    want = jax_model_summary(jm, jm.init(jax.random.PRNGKey(0), x[:1],
                                         train=False), x)
    model = get_pose_net(resnet_cfg())
    got = model_summary(model, torch.zeros(2, 3, 256, 256))
    assert got["params"] == want["params"] == 11315940
    assert got["batch_stats"] == want["batch_stats"]
    assert got["bytes_accessed_per_batch"] is None
    ratio = got["flops_per_batch"] / want["flops_per_batch"]
    assert 1.0 <= ratio <= 1.08, ratio
    table = per_layer_summary(model, torch.zeros(1, 3, 64, 64), depth=1)
    assert "layer4" in table and "8,393,728" in table
    assert format_summary(got, "res18").splitlines()[1] == \
        "   params: 11.32M"


def test_summary_leaves_the_model_alone():
    """A train-mode count runs on a copy: the BN statistics and the
    model's mode stay."""
    model = get_pose_net(resnet_cfg()).eval()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    model_summary(model, torch.randn(2, 3, 64, 64), train=True)
    assert all(torch.equal(v, before[k])
               for k, v in model.state_dict().items())
    assert not model.training


def test_hbm_peak_tiny_on_cpu(capsys):
    out = hbm_peak.main(["--mb", "2", "--iters", "2", "--device", "cpu"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["device"] == "cpu" and last["card"] is None
    assert out["measured_peak_gbs"] == max(out["scale"], out["triad"]) > 0


def test_loader_bench_tiny():
    res = loader_bench.loader_bench(n=6, batch=3, threads=2)
    assert res["threads"] == 2 and res["n_images"] == 6
    for mode in ("decode_warp", "decode_only"):
        assert res[f"{mode}_img_s"] > 0
        assert res[f"{mode}_img_s_per_thread"] == pytest.approx(
            res[f"{mode}_img_s"] / 2)
    bu = loader_bench.bottomup_loader_bench(n=4, batch=2, threads=2,
                                            input_size=128)
    assert bu["n_images"] == 4 and bu["bottomup_img_s"] > 0


def _parity(argv, tmp_path):
    return parity_check.main(argv + ["--device", "cpu", "OUTPUT_DIR",
                                     str(tmp_path)])


def test_parity_skips_cleanly_when_data_absent(tmp_path, capsys,
                                               monkeypatch):
    monkeypatch.chdir(tmp_path)  # DATASET.ROOT data/coco/ is not there
    rc = _parity(["--cfg", W32, "--ckpt", str(tmp_path / "missing.pth")],
                 tmp_path)
    out = capsys.readouterr().out
    assert rc == 0 and "PARITY SKIPPED" in out and "coco" in out


def test_parity_unknown_arch_without_expectation_is_an_error(tmp_path,
                                                             capsys):
    rc = _parity(["--cfg", SMOKE_CFG, "--ckpt", str(tmp_path / "none"),
                  "--allow_random_init"], tmp_path)
    assert rc == 2 and "no --expect_ap" in capsys.readouterr().out


def test_parity_missing_checkpoint_and_jax_directory(tmp_path, capsys):
    rc = _parity(["--cfg", SMOKE_CFG, "--ckpt", str(tmp_path / "w.pth"),
                  "--expect_ap", "1"], tmp_path)
    assert rc == 2 and "not found" in capsys.readouterr().out
    (tmp_path / "final_state").mkdir()
    with pytest.raises(SystemExit, match="directory"):
        _parity(["--cfg", SMOKE_CFG, "--ckpt", str(tmp_path / "final_state"),
                 "--expect_ap", "1"], tmp_path)


@pytest.mark.slow
def test_parity_fail_and_pass_exit_codes_on_real_validation(tmp_path,
                                                            capsys):
    """The whole validate path on the synthetic dataset (random init, PCK a
    few %): an unreachable expectation exits 1 with a FAIL report, a beaten
    one 0."""
    rc = _parity(["--cfg", SMOKE_CFG, "--ckpt", str(tmp_path / "none"),
                  "--allow_random_init", "--expect_ap", "50"], tmp_path)
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1 and rep["result"] == "FAIL"
    assert rep["checks"][0]["metric"] == "clean AP"
    assert rep["checks"][0]["measured"] < 50
    rc = _parity(["--cfg", SMOKE_CFG, "--ckpt", str(tmp_path / "none"),
                  "--allow_random_init", "--expect_ap", "1"], tmp_path)
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and rep["result"] == "PASS"
