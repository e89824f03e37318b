"""TEST.INT8 and TRAIN.INT8_TEACHER through the port's entry points on the
CPU (`tools/test_corruption.main`, `tools/train.main`, `--device cpu`):

- the sweep with TEST.INT8 on the synthetic set (PoseResNet-18 64x64) and
  on a small bottom-up COCO tree (a narrowed HigherHRNet): it logs how many
  convolutions it calibrated on how many batches, every pass's score is
  finite, and the top-down clean pass equals a direct `validate` of the
  quantized model built by hand from the same calibration batches;
- the AdvMix training with TRAIN.INT8_TEACHER for one iteration: the
  teacher is the quantized copy of D, and the losses are finite; on a
  bottom-up config the key warns and is ignored, as in the JAX package;
- no "not ported yet" stop is left in the port.
"""

import glob
import os

import numpy as np
import pytest
import torch

from advmix_tpu_torch.config import load_config
from advmix_tpu_torch.data import Loader, build_dataset
from advmix_tpu_torch.engine import steps, trainer
from advmix_tpu_torch.models import get_pose_net
from advmix_tpu_torch.models.layers import set_compute_dtype
from advmix_tpu_torch.ops import quant
from advmix_tpu_torch.tools import test_corruption as sweep_tool
from advmix_tpu_torch.tools import train as train_tool

from test_torch_bottomup_steps import _write_yaml, coco_tree  # noqa: F401
from test_torch_higher_hrnet import seeded_higher

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "experiments/synthetic/res18_64x64_smoke.yaml")
RESNET18_CONVS = 20  # conv1, 16 block convs, 3 downsamples


def _log(out_dir, phase):
    (path,) = glob.glob(os.path.join(out_dir, f"*_{phase}.log"))
    return open(path).read()


def test_sweep_int8_top_down(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    opts = ["DATASET.SYNTH_LENGTH", "16", "TEST.INT8", "True",
            "TEST.INT8_CALIB_BATCHES", "1", "TEST.INT8_CALIB_MARGIN", "1.5"]
    result = sweep_tool.main(["--cfg", SMOKE, "--device", "cpu",
                              "--on_the_fly", "--distortions", "contrast",
                              *opts])
    runs = result["runs"]
    assert [(c, s) for c, s, _, _ in runs] == [("clean", 0)] + [
        ("contrast", s) for s in range(5)]
    assert all(np.isfinite(r[3]) for r in runs)
    log = _log(result["output_dir"], "valid")
    assert (f"=> int8 eval: {RESNET18_CONVS} convs calibrated on 1 "
            "batch(es)") in log

    # the clean pass is validate() of the quantized model built by hand
    cfg = load_config(SMOKE, opts)
    model = get_pose_net(cfg).eval()
    ds = build_dataset(cfg, False, None)
    scales = quant.calibrate_from_loader(model, Loader(ds, 8), 1,
                                         torch.device("cpu"), margin=1.5)
    assert len(scales) == RESNET18_CONVS
    q = quant.quantize_model(model, scales)
    _, perf = trainer.validate(
        cfg, steps.make_eval_step(q, cfg, ds.flip_pairs),
        trainer.make_eval_preprocessor(cfg, torch.device("cpu")), ds,
        Loader(ds, 8), str(tmp_path / "direct"), torch.device("cpu"))
    assert runs[0][3] == perf


def test_sweep_int8_bottom_up(coco_tree, tmp_path, monkeypatch):  # noqa: F811
    monkeypatch.chdir(tmp_path)
    cfg_path = _write_yaml(tmp_path / "bu.yaml", coco_tree)
    model, _ = seeded_higher(seed=4, joints=17)
    torch.save(model.state_dict(), tmp_path / "start.pth")
    n_convs = len(quant.conv_paths(model))
    assert n_convs == sum(isinstance(m, torch.nn.Conv2d)
                          for m in model.modules()) - 2  # final_layers
    result = sweep_tool.main([
        "--cfg", cfg_path, "--device", "cpu", "--on_the_fly",
        "--distortions", "contrast", "--exp_id", "bu",
        "TEST.MODEL_FILE", str(tmp_path / "start.pth"), "TEST.INT8", "True",
        "TEST.INT8_CALIB_BATCHES", "1"])
    assert len(result["runs"]) == 6
    assert all(np.isfinite(r[3]) for r in result["runs"])
    assert (f"=> int8 eval: {n_convs} convs calibrated on 1 batch(es)"
            in _log(result["output_dir"], "valid"))


def test_train_int8_teacher_one_iteration(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = train_tool.main([
        "--cfg", SMOKE, "--device", "cpu", "--advmix", "--sample_times", "3",
        "--downsamples", "4", "DATASET.SYNTH_LENGTH", "8", "PRINT_FREQ", "1",
        "TRAIN.INT8_TEACHER", "True", "TEST.INT8_CALIB_BATCHES", "1"])
    teacher = out["state"].teacher
    assert len(teacher.quantized_paths) == RESNET18_CONVS
    assert isinstance(teacher.conv1, quant.QuantConv2d)
    assert not teacher.training
    assert not any(p.requires_grad for p in teacher.parameters())
    (epoch,) = out["history"]
    assert len(epoch) == 1  # one iteration of batch 8
    assert all(np.isfinite(m["loss_d"]) and np.isfinite(m["loss_g"])
               for m in epoch)
    log = _log(out["output_dir"], "train")
    assert f"=> int8 teacher: {RESNET18_CONVS} convs calibrated" in log
    # quantized from D's f32 weights as loaded: the same codes as a copy
    cfg = load_config(SMOKE)
    d0 = set_compute_dtype(get_pose_net(cfg), torch.float32, trainable=True)
    wq, _ = quant.quantize_weight(d0.conv1.weight)
    assert torch.equal(quant.quantize_weight(teacher.conv1.weight)[0], wq)


def test_train_int8_teacher_bottom_up_is_ignored(coco_tree, tmp_path,  # noqa: F811
                                                 monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg_path = _write_yaml(tmp_path / "bu.yaml", coco_tree)
    out = train_tool.main(["--cfg", cfg_path, "--device", "cpu", "--advmix",
                           "--sample_times", "3", "--downsamples", "4",
                           "TRAIN.INT8_TEACHER", "True"])
    assert not any(isinstance(m, quant.QuantConv2d)
                   for m in out["state"].teacher.modules())
    assert np.isfinite(out["perf"])
    assert "TRAIN.INT8_TEACHER ignored for bottom-up" in _log(
        out["output_dir"], "train")


@pytest.mark.parametrize("key", ["TEST.INT8", "TRAIN.INT8_TEACHER"])
def test_no_not_ported_stop_is_left(key):
    for path in glob.glob(os.path.join(ROOT, "advmix_tpu_torch", "**",
                                       "*.py"), recursive=True):
        src = open(path).read()
        assert "not ported yet" not in src, path
        assert "reject_later_slices" not in src, path
    # and both keys are read where the JAX package reads them
    tool = "test_corruption.py" if key == "TEST.INT8" else "train.py"
    src = open(os.path.join(ROOT, "advmix_tpu_torch", "tools", tool)).read()
    assert f"cfg.{key}" in src
    assert "cfg.TEST.INT8_CALIB_BATCHES" in src
    assert "cfg.TEST.INT8_CALIB_MARGIN" in src
