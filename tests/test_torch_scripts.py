"""The port's shell surface, `advmix_tpu_torch/scripts/`, on the CPU
(DEVICE=cpu):

- `demo_summary.py` prints the same bytes as the JAX package's
  `scripts/demo_summary.py` on CSVs that the port's `write_final_csv`
  writes, for the synthetic and the MPII column names, with and without
  the equal-budget arm;
- `advmix_demo.sh` end to end at EPOCHS=1 on 32 synthetic samples and a
  one-corruption sweep: three state files that load into the demo's
  model, three sweeps of 6 passes, the summary;
- `int8_teacher_ab.sh` in the demo's work directory: the standard arm is
  reused, the int8 arm's log names its teacher, the deltas are printed,
  and the f32 arm equals the demo's advmix arm bit for bit (the same
  command: every draw of a run is seeded, so the A/B's arms differ only in
  the teacher);
- a missing state file stops the scripts' sweep step, and without a card
  and without DEVICE=cpu the demo stops;
- `train.sh` then `test.sh` on two gloo ranks, and `make_datasets.sh`, as
  `tests/test_scripts.py` runs the JAX package's scripts.
"""

import csv
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from advmix_tpu_torch.config import load_config
from advmix_tpu_torch.models import get_pose_net, load_model_file
from advmix_tpu_torch.tools.test_corruption import BENCHMARK_15, \
    write_final_csv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "advmix_tpu_torch", "scripts")
DEMO_CFG = os.path.join(ROOT,
                        "experiments/synthetic/res18_64x64_robust_demo.yaml")
SMOKE_CFG = "experiments/synthetic/res18_64x64_smoke.yaml"
ARMS = ("standard", "advmix", "standard400")


def run_script(script, args, env_extra, timeout=600):
    env = dict(os.environ, PYTHON=sys.executable, PYTHONPATH=ROOT,
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2", DEVICE="cpu")
    env.update(env_extra)
    return subprocess.run(["bash", os.path.join(SCRIPTS, script), *args],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=timeout)


def ok(proc):
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc


def write_arms(work, dataset, tags, seed):
    rng = np.random.RandomState(seed)
    for tag in tags:
        vals = rng.uniform(0.2, 0.5, len(BENCHMARK_15) * 5).tolist()
        write_final_csv([float(rng.uniform(0.6, 0.9))] + vals, BENCHMARK_15,
                        str(work), f"results_{tag}", dataset)


@pytest.mark.parametrize("dataset", ["synthetic", "mpii"])
@pytest.mark.parametrize("with_control", [True, False])
def test_demo_summary_prints_the_jax_bytes(tmp_path, dataset, with_control):
    tags = ARMS if with_control else ARMS[:2]
    write_arms(tmp_path, dataset, tags, seed=len(tags))
    with open(tmp_path / "results_standard.csv") as f:
        header = next(csv.reader(f))
    metric = "mean" if dataset == "mpii" else "mAP"
    assert header[:2] == [f"clean_{metric}", f"mean_corrupted_{metric}"]

    def summary(cmd):
        return ok(subprocess.run(cmd + [str(tmp_path)], cwd=ROOT,
                                 capture_output=True, timeout=60)).stdout

    want = summary([sys.executable, os.path.join(ROOT, "scripts",
                                                 "demo_summary.py")])
    got = summary([sys.executable, "-m",
                   "advmix_tpu_torch.scripts.demo_summary"])
    assert got == want
    control = "standard400" if with_control else "standard"
    assert f"rPC delta (advmix - {control})".encode() in got
    assert got.count(b"clean=") == len(tags)


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    """One run of advmix_demo.sh at EPOCHS=1: (work dir, the knobs, the
    process)."""
    tmp = tmp_path_factory.mktemp("demo")
    knobs = dict(EPOCHS="1", AB_EXTRA_OPTS="DATASET.SYNTH_LENGTH 32",
                 DISTORTIONS="gaussian_noise", OUTPUT_DIR=str(tmp / "out"),
                 LOG_DIR=str(tmp / "log"))
    work = tmp / "work"
    proc = run_script("advmix_demo.sh", [str(work)], knobs)
    return work, knobs, proc


def sweep_lines(path):
    with open(path) as f:
        return [ln.split(":")[0] for ln in f.read().splitlines()
                if ln.strip()]


def test_advmix_demo_end_to_end(demo):
    work, _, proc = demo
    ok(proc)
    for tag in ARMS:
        # the port's final_state is one torch file, which the demo's model
        # loads strictly
        model = get_pose_net(load_config(DEMO_CFG))
        load_model_file(model, str(work / f"{tag}_state"))
        assert sweep_lines(work / f"robust_{tag}.val") == [
            "clean_0"] + [f"gaussian_noise_{s}" for s in range(5)]
        with open(work / f"results_{tag}.csv") as f:
            row = next(csv.DictReader(f))
        assert 0.0 <= float(row["clean_mAP"]) <= 1.0
        assert 0.0 <= float(row["mean_corrupted_mAP"]) <= 1.0
    # the advmix arm and the control both start from the standard arm
    assert proc.stderr.count(f"loaded D from {work}/standard_state") == 2
    assert "=> int8 teacher" not in proc.stderr
    lines = proc.stdout.splitlines()
    start = lines.index("=== AdvMix robustness demo summary ===")
    assert [ln.split()[0] for ln in lines[start + 1:start + 4]] == \
        ["standard", "standard400", "advmix"]
    assert lines[start + 4].startswith("rPC delta (advmix - standard400): ")
    assert lines[start + 5].startswith("mPC delta (advmix - standard400): ")


def test_int8_teacher_ab_reuses_the_demo_standard_arm(demo):
    work, knobs, _ = demo
    standard = (work / "standard_state").read_bytes()
    proc = ok(run_script("int8_teacher_ab.sh", [str(work)], knobs))
    assert "[1/5] standard training" not in proc.stdout
    assert (work / "standard_state").read_bytes() == standard
    log = proc.stdout + proc.stderr
    assert "int8 teacher:" in log.lower()
    assert log.count(f"loaded D from {work}/standard_state") == 2
    lines = proc.stdout.splitlines()
    assert lines[-4].split() == ["arm", "clean", "mPC", "rPC"]
    assert lines[-1].startswith("delta (B-A)")
    assert len(lines[-1].split()) == 5
    # the f32 arm's command is the demo's advmix arm's: seeded draws make
    # them the same run, so the two A/B arms differ only in the teacher
    f32 = torch.load(work / "f32_state", map_location="cpu")
    advmix = torch.load(work / "advmix_state", map_location="cpu")
    int8 = torch.load(work / "int8_state", map_location="cpu")
    assert all(torch.equal(f32[k], advmix[k]) for k in advmix)
    assert not all(torch.equal(int8[k], f32[k]) for k in f32)
    assert (work / "results_f32.csv").read_bytes() == \
        (work / "results_advmix.csv").read_bytes()


def test_missing_state_file_stops_the_demo_sweep(tmp_path):
    # the demo's `sweep` step, as its scripts call it, on a work directory
    # whose standard arm was never saved
    work, out = tmp_path / "work", tmp_path / "out"
    work.mkdir()
    env = dict(os.environ, PYTHON=sys.executable, PYTHONPATH=ROOT,
               CUDA_VISIBLE_DEVICES="", DEVICE="cpu", OUTPUT_DIR=str(out),
               WORK=str(work))
    proc = subprocess.run(
        ["bash", "-c", ". advmix_tpu_torch/scripts/arms.sh; "
                       'sweep "$WORK/standard_state" standard; echo swept'],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=60)
    assert proc.returncode != 0
    assert f"no state file {work}/standard_state" in proc.stderr
    assert "swept" not in proc.stdout
    assert os.listdir(work) == []
    assert not os.path.exists(str(out) + "_robustness")  # nothing swept


def test_demo_without_a_card_stops(tmp_path):
    proc = run_script("advmix_demo.sh", [str(tmp_path / "work")],
                      dict(DEVICE="", OUTPUT_DIR=str(tmp_path / "out"),
                           LOG_DIR=str(tmp_path / "log")))
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
    assert os.listdir(tmp_path / "work") == []


def test_train_then_test_scripts(tmp_path):
    out_dir = str(tmp_path / "out")
    opts = ["OUTPUT_DIR", out_dir, "LOG_DIR", str(tmp_path / "log"),
            "TRAIN.END_EPOCH", "1", "DATASET.SYNTH_LENGTH", "32"]
    proc = ok(run_script("train.sh", ["--num_devices", "2"] + opts,
                         {"CFG": SMOKE_CFG,
                          "LOAD_FROM_D": str(tmp_path / "absent.pth")}))
    assert "training D + teacher from random init" in proc.stderr
    final = os.path.join(out_dir, "synthetic", "pose_resnet",
                         "res18_64x64_smoke", "final_state")
    assert os.path.isfile(final)

    ok(run_script("test.sh", opts, {
        "CFG": SMOKE_CFG, "MODEL_FILE": final,
        "FLAGS": "--num_devices 2 --on_the_fly --distortions gaussian_noise"}))
    csvs = [os.path.join(root, f)
            for root, _, fs in os.walk(out_dir + "_robustness")
            for f in fs if f.endswith(".csv")]
    assert [os.path.basename(p) for p in csvs] == ["robust.csv"]
    with open(csvs[0]) as f:
        header = f.readline()
    assert "clean_" in header and "mean_corrupted_" in header


def test_test_script_refuses_a_missing_model_file(tmp_path):
    proc = run_script("test.sh", ["OUTPUT_DIR", str(tmp_path / "out")],
                      {"CFG": SMOKE_CFG,
                       "MODEL_FILE": str(tmp_path / "absent")})
    assert proc.returncode != 0
    assert f"no model file {tmp_path}/absent" in proc.stderr
    assert not os.listdir(tmp_path)


def test_make_datasets_script(tmp_path):
    src = tmp_path / "imgs"
    src.mkdir()
    rng = np.random.RandomState(0)
    for i, (h, w) in enumerate([(40, 60), (37, 55)]):
        cv2.imwrite(str(src / f"{i:012d}.jpg"),
                    rng.randint(0, 255, (h, w, 3), np.uint8))
    proc = ok(run_script(
        "make_datasets.sh", ["--corruptions", "gaussian_noise",
                             "--bucket_quantum", "64"],
        {"COCO_ROOT": str(src), "MPII_ROOT": str(tmp_path / "absent"),
         "OUT_ROOT": str(tmp_path)}))
    assert "skipping MPII-C" in proc.stderr
    for sev in range(5):
        d = tmp_path / "coco-C" / "gaussian_noise" / str(sev)
        assert sorted(os.listdir(d)) == ["000000000000.jpg",
                                         "000000000001.jpg"]
    out = cv2.imread(str(tmp_path / "coco-C/gaussian_noise/0/"
                                    "000000000001.jpg"))
    assert out.shape == (37, 55, 3)
