"""The port's train entry point, `python -m advmix_tpu_torch.tools.train
--device cpu`, on experiments/synthetic/res18_64x64_smoke.yaml: standard and
AdvMix training run, checkpoint, resume and export; the validate entry point
reads the export back; the int8 option of a later slice stops with its
message, also on the bottom-up configs; the reference's own AdvMix command
(scripts/train.sh) parses, and each flag the reference parses and never
reads is accepted with a warning that names it; a directory as
TEST.MODEL_FILE (a JAX orbax final_state) stops validate and the sweep; and
without a card the entry point raises unless asked for the CPU.
"""

import os
import subprocess
import sys
import warnings

import pytest
import torch

from advmix_tpu_torch.config import load_config
from advmix_tpu_torch.models import get_pose_net, load_model_file
from advmix_tpu_torch.tools import train as train_tool
from advmix_tpu_torch.tools import validate as validate_tool

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "experiments/synthetic/res18_64x64_smoke.yaml")
HIGHER = os.path.join(ROOT,
                      "experiments/coco/higher_hrnet/w32_512_advmix.yaml")
# two threads: the suite runs several workers side by side
ENV = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="",
           OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
torch.set_num_threads(2)
OUT = "output/synthetic/pose_resnet/res18_64x64_smoke"
SMALL = ["DATASET.SYNTH_LENGTH", "16", "PRINT_FREQ", "1"]


def _run(tool, cwd, *args, ok=True):
    proc = subprocess.run(
        [sys.executable, "-m", f"advmix_tpu_torch.tools.{tool}", "--cfg",
         SMOKE, *args], cwd=str(cwd), env=ENV, capture_output=True, text=True,
        timeout=300)
    assert (proc.returncode == 0) == ok, proc.stderr[-3000:]
    return proc.stderr + proc.stdout


@pytest.mark.parametrize("mode", ["standard", "advmix"])
def test_train_checkpoints_resumes_and_exports(tmp_path, monkeypatch, mode):
    """The first run is a subprocess of `python -m`; the runs that follow
    it (validate, resume) call the same `main` in this process."""
    flags = (["--advmix", "--sample_times", "3", "--alpha", "0.3",
              "--downsamples", "4"] if mode == "advmix" else [])
    log = _run("train", tmp_path, "--device", "cpu", *flags, *SMALL)
    assert "Epoch: [0][1/2]" in log and "=> epoch 0 lr 0.001" in log
    assert "| pose_resnet | " in log  # the per-epoch validation ran
    out = tmp_path / OUT
    for name in ("checkpoint.pth", "model_best.pth", "final_state"):
        assert (out / name).is_file(), name
    ckpt = torch.load(out / "checkpoint.pth", map_location="cpu")
    assert ckpt["epoch"] == 0 and ckpt["step"] == 2
    want_keys = {"model_d", "optimizer_d", "epoch", "perf", "step"}
    if mode == "advmix":
        want_keys |= {"model_g", "optimizer_g"}
        # --downsamples 4: four down and four up convs, weight and bias
        assert len(ckpt["model_g"]) == 16
    assert set(ckpt) == want_keys
    assert all(v.dtype == torch.float32 for v in ckpt["model_d"].values()
               if v.is_floating_point())
    tracked = [v for k, v in ckpt["model_d"].items()
               if k.endswith("num_batches_tracked")]
    # AdvMix runs D in train mode twice per iteration
    assert all(int(t) == (4 if mode == "advmix" else 2) for t in tracked)

    # the export loads strictly, holds what the checkpoint holds, and moved
    cfg = load_config(SMOKE)
    model = get_pose_net(cfg)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    load_model_file(model, str(out / "final_state"))
    for k, v in model.state_dict().items():
        assert torch.equal(v, ckpt["model_d"][k]), k
    assert not torch.equal(start["final_layer.weight"],
                           model.state_dict()["final_layer.weight"])

    monkeypatch.chdir(tmp_path)
    base = ["--cfg", SMOKE, "--device", "cpu"]
    # the validate entry point reads the final state
    _, perf = validate_tool.main(base + SMALL + [
        "TEST.MODEL_FILE", str(out / "final_state")])
    assert perf == pytest.approx(ckpt["perf"])
    logs = list((tmp_path / "output_robustness").rglob("*_valid.log"))
    assert len(logs) == 1 and "=> loaded model" in logs[0].read_text()

    # AUTO_RESUME at the last epoch: nothing left to train
    again = train_tool.main(base + flags + SMALL + ["AUTO_RESUME", "True"])
    assert again["begin_epoch"] == 1 and again["history"] == []
    assert again["state"].step == 2
    for k, v in again["state"].model_d.state_dict().items() \
            if mode == "advmix" else again["state"].model.state_dict().items():
        assert torch.equal(v, ckpt["model_d"][k]), k
    # and with one more epoch to go it trains that one, from the checkpoint
    more = train_tool.main(base + flags + SMALL + [
        "AUTO_RESUME", "True", "TRAIN.END_EPOCH", "2"])
    assert more["begin_epoch"] == 1 and len(more["history"]) == 1
    assert len(more["history"][0]) == 2
    ckpt2 = torch.load(out / "checkpoint.pth", map_location="cpu")
    assert ckpt2["epoch"] == 1 and ckpt2["step"] == 4
    opt = ckpt2["optimizer_d"]["state"]
    assert opt and all(float(s["step"]) == 4 for s in opt.values())


INT8 = "not ported yet: TRAIN.INT8_TEACHER needs ops/quant.py: the int8 " \
    "and serving slice"


@pytest.mark.parametrize("args,message", [
    (["TRAIN.INT8_TEACHER", "True", "DATASET.DATASET", "bottomup_coco"],
     INT8),
    (["TRAIN.INT8_TEACHER", "True", "DATASET.DATASET", "ochuman"], INT8),
    (["TRAIN.INT8_TEACHER", "True"], INT8),
    (["TRAIN.INT8_TEACHER", "True", "MODEL.NAME", "pose_higher_hrnet"],
     INT8),
])
def test_later_slice_options_stop_with_their_message(tmp_path, monkeypatch,
                                                     args, message):
    """The int8 arm is the only one left: the bottom-up names are ported
    and no longer appear in the message."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as err:
        train_tool.main(["--cfg", SMOKE, "--device", "cpu", *args])
    assert str(err.value) == message
    assert not os.listdir(tmp_path)  # it stopped before writing anything


def test_later_slice_flag_exits_nonzero(tmp_path):
    log = _run("train", tmp_path, "--device", "cpu", "TRAIN.INT8_TEACHER",
               "True", ok=False)
    assert "not ported yet: TRAIN.INT8_TEACHER" in log


def test_train_without_card_raises(tmp_path):
    log = _run("train", tmp_path, ok=False)
    assert "no CUDA device is available" in log
    assert not os.listdir(tmp_path)


def test_load_from_d_and_g_warm_start(tmp_path, monkeypatch):
    """--load_from_D feeds D and the teacher, --load_from_G feeds G, and
    main() hands the state back."""
    from advmix_tpu_torch.models import get_generator

    monkeypatch.chdir(tmp_path)
    cfg = load_config(SMOKE)
    d0, g0 = get_pose_net(cfg), get_generator()
    with torch.no_grad():
        for p in list(d0.parameters()) + list(g0.parameters()):
            p.add_(0.01)
    torch.save(d0.state_dict(), "d.pth")
    torch.save({"state_dict": g0.state_dict()}, "g.pth")
    out = train_tool.main([
        "--cfg", SMOKE, "--device", "cpu", "--advmix", "--sample_times", "3",
        "--load_from_D", "d.pth", "--load_from_G", "g.pth",
        "DATASET.SYNTH_LENGTH", "8", "TRAIN.END_EPOCH", "0"])
    state = out["state"]
    assert out["history"] == [] and state.step == 0
    for k, v in d0.state_dict().items():
        assert torch.equal(state.model_d.state_dict()[k], v)
        assert torch.equal(state.teacher.state_dict()[k], v)
    for k, v in g0.state_dict().items():
        assert torch.equal(state.model_g.state_dict()[k], v)
    assert os.path.isfile(out["final_state"])


def test_load_pretrained_takes_matching_layers_only(tmp_path):
    """MODEL.PRETRAINED: a backbone file seeds the layers that
    PRETRAINED_LAYERS names, where name and shape agree; a file that
    matches nothing raises."""
    from advmix_tpu_torch.models import load_pretrained

    cfg = load_config(SMOKE)
    donor, model = get_pose_net(cfg), get_pose_net(cfg)
    with torch.no_grad():
        for p in donor.parameters():
            p.add_(1.0)
    sd = {"module." + k: v for k, v in donor.state_dict().items()}
    sd["module.final_layer.weight"] = torch.zeros(3, 3)  # another head
    path = str(tmp_path / "backbone.pth")
    torch.save({"state_dict": sd}, path)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    n = load_pretrained(model, path, ["conv1", "bn1", "layer1"])
    after = model.state_dict()
    assert n == sum(k.split(".")[0] in ("conv1", "bn1", "layer1")
                    for k in after)
    assert torch.equal(after["conv1.weight"], donor.state_dict()["conv1.weight"])
    assert torch.equal(after["layer2.0.conv1.weight"],
                       before["layer2.0.conv1.weight"])
    n_all = load_pretrained(model, path, ["*"])
    assert n_all == len(after) - 1  # all but the mismatched head
    assert torch.equal(model.state_dict()["final_layer.weight"],
                       before["final_layer.weight"])
    torch.save({"unrelated": torch.zeros(1)}, path)
    with pytest.raises(KeyError):
        load_pretrained(model, path)


def test_reference_train_script_arguments_parse(tmp_path, monkeypatch):
    """The argument list of scripts/train.sh (the reference's AdvMix
    command, with --kd_mseloss) trains through the port's entry point."""
    import re
    import shlex

    line = next(ln for ln in open(os.path.join(ROOT, "scripts/train.sh"))
                if ln.startswith("ARGS=("))
    args = shlex.split(re.match(r"ARGS=\((.*)\)", line.strip())[1])
    assert "--kd_mseloss" in args and args[:2] == ["--cfg", '$CFG']
    args[1] = SMOKE
    monkeypatch.chdir(tmp_path)
    out = train_tool.main(args + ["--device", "cpu", "--downsamples", "4",
                                  *SMALL])
    assert len(out["history"][0]) == 2
    assert all(m["loss_g"] < 0 for m in out["history"][0])


@pytest.mark.parametrize("flag,value", [
    ("--kd_klloss", None), ("--combine_prob", "0.3"),
    ("--perturb_joint", "0.1"), ("--perturb_range", "3"),
    ("--joints_num", "17"), ("--prevModelDir", "prev"),
    ("--save_suffix", "x"), ("--load_json_file", "a.json")])
def test_reference_only_flags_warn_with_their_name(flag, value):
    from advmix_tpu_torch.tools._parse import parse_args

    argv = ["--cfg", SMOKE, flag] + ([value] if value else [])
    with pytest.warns(UserWarning) as rec:
        args = parse_args(argv)
    assert len(rec) == 1 and str(rec[0].message).startswith(
        f"{flag} is accepted and ignored")
    assert not hasattr(args, flag[2:])
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # without the flag: no warning
        parse_args(["--cfg", SMOKE, "--kd_mseloss", "--test_robust",
                    "--corruption_type", "fog", "--severity", "2"])


@pytest.mark.parametrize("tool", ["validate", "test_corruption"])
def test_directory_model_file_stops_the_run(tmp_path, monkeypatch, tool):
    """A JAX orbax final_state is a directory: the pass must not evaluate
    the random init as if it had loaded it."""
    from advmix_tpu_torch.tools import test_corruption as sweep_tool

    monkeypatch.chdir(tmp_path)
    orbax = tmp_path / "final_state"
    orbax.mkdir()
    main = validate_tool.main if tool == "validate" else sweep_tool.main
    extra = ["--on_the_fly"] if tool == "test_corruption" else []
    with pytest.raises(SystemExit) as err:
        main(["--cfg", SMOKE, "--device", "cpu", *extra, *SMALL,
              "TEST.MODEL_FILE", str(orbax)])
    msg = str(err.value)
    assert str(orbax) in msg and "is a directory" in msg and ".npz" in msg
    proc = subprocess.run(
        [sys.executable, "-m", f"advmix_tpu_torch.tools.{tool}", "--cfg",
         SMOKE, "--device", "cpu", *extra, *SMALL, "TEST.MODEL_FILE",
         str(orbax)], cwd=str(tmp_path), env=ENV, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode != 0 and "is a directory" in proc.stderr
