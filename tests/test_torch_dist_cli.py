"""The multi-rank entry points and launcher on the CPU.

- `tools/train.main --num_devices 2 --device cpu` on the synthetic smoke
  YAML trains on two gloo ranks: rank 0's dict comes back (its state on
  the CPU), rank 0 alone writes the log, the checkpoint and the final
  state, and a second call resumes from the checkpoint on both ranks;
- the parallel layer's collectives on rank-dependent values;
- `--num_devices` above the card count stops with a message naming both
  numbers, and never runs fewer ranks;
- a rank that fails makes the launch fail with its traceback, and the rank
  waiting for it is stopped;
- torchrun's ranks (`python -m torch.distributed.run --standalone`) train
  the same YAML, and without a card and without `--device cpu` they fail
  instead of training on the CPU.
"""

import glob
import os
import subprocess
import sys

import pytest
import torch

from advmix_tpu_torch.parallel.dist import launch
from advmix_tpu_torch.tools import train as train_tool

from torch_dist_worker import collectives, fail_on_rank, rank_sys_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "experiments/synthetic/res18_64x64_smoke.yaml")


@pytest.fixture(scope="module", autouse=True)
def _rank_sys_path():
    with rank_sys_path():
        yield


def _argv(tmp_path, *extra):
    return ["--cfg", SMOKE, "--device", "cpu", "--num_devices", "2",
            "OUTPUT_DIR", str(tmp_path / "out"), "LOG_DIR",
            str(tmp_path / "log"), "DATASET.SYNTH_LENGTH", "40", *extra]


def test_train_on_two_ranks_checkpoints_once_and_resumes(tmp_path):
    out = train_tool.main(_argv(tmp_path))
    # 40 samples in global batches of 2 x 8, the last partial one dropped
    assert [len(h) for h in out["history"]] == [2]
    assert out["state"].step == 2
    assert all(p.device.type == "cpu" for p in out["state"].model.parameters())
    run = out["output_dir"]
    assert os.path.isfile(os.path.join(run, "checkpoint.pth"))
    assert os.path.isfile(out["final_state"])
    assert len(glob.glob(os.path.join(run, "*_train.log"))) == 1
    saved = torch.load(os.path.join(run, "checkpoint.pth"), map_location="cpu")
    assert saved["step"] == 2
    for k, v in out["state"].model.state_dict().items():
        assert torch.equal(v, saved["model_d"][k]), k

    again = train_tool.main(_argv(tmp_path, "AUTO_RESUME", "True",
                                  "TRAIN.END_EPOCH", "2"))
    assert again["begin_epoch"] == 1 and [len(h) for h in
                                          again["history"]] == [2]
    assert again["state"].step == 4


def test_collectives_on_two_ranks():
    r0, r1 = launch(collectives, ["cpu", "cpu"])
    for part in (r0, r1):
        assert part["a"] == [1.5] * 3 and part["b"] == [0.0, 1.5, 3.0, 4.5]
        assert part["mean"] == [0.5, 0.5] and part["var"] == [1.0, 1.0]
        assert part["weight"] == [3.0] * 4
        # the ranks' losses (q + 1) * mean(x) summed over q, differentiated
        # by x_r: sum_q (q + 1) / 2, pmean's transpose
        assert part["grad"] == [1.5, 1.5]
    # the count is each rank's own; the seeds are rank 0's and a new one
    assert (r0["tracked"], r1["tracked"]) == (5, 6)
    assert r0["fold"] == 1234 and r1["fold"] != 1234


def test_num_devices_above_the_card_count_stops(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="--num_devices 3 asks for more "
                                         "cards than the 1"):
        train_tool.main(["--cfg", SMOKE, "--num_devices", "3"])
    assert not os.listdir(tmp_path)


def test_a_failing_rank_fails_the_launch():
    with pytest.raises(RuntimeError, match=r"rank\(s\) \[.*1\] of 2 failed") \
            as e:
        launch(fail_on_rank, ["cpu", "cpu"], 1)
    assert "--- rank 1:" in str(e.value)
    assert "planted failure on rank 1" in str(e.value)


def test_torchrun_ranks_train(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "advmix_tpu_torch.tools.train",
         *_argv(tmp_path)], cwd=str(tmp_path), env=env, capture_output=True,
        text=True, timeout=300)
    log = proc.stdout + proc.stderr
    assert proc.returncode == 0, log[-3000:]
    assert "2 rank(s)" in log and "Epoch: [0][0/2]" in log
    run = tmp_path / "out/synthetic/pose_resnet/res18_64x64_smoke"
    assert (run / "checkpoint.pth").is_file()
    assert (run / "final_state").is_file()


def test_torchrun_ranks_without_a_card_fail(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    argv = [a for a in _argv(tmp_path) if a not in ("--device", "cpu",
                                                   "--num_devices", "2")]
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "advmix_tpu_torch.tools.train",
         *argv], cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    log = proc.stdout + proc.stderr
    assert proc.returncode != 0, log[-3000:]
    assert "no CUDA device is available" in log, log[-3000:]
    assert not (tmp_path / "out").exists()
