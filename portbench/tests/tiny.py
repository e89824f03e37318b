"""A cell of BENCHMARK.json cut to a size the CPU tests can run: 64x64
inputs, narrowed HRNet stages or ResNet-18 with narrow deconvolutions, a
batch of 4, a few passes of the sweep, float32 by default (the program then
matches the reference to rounding)."""

from __future__ import annotations

import copy
import time

import torch

from portbench import core


def tiny_cell(name: str, dtype: str = "float32") -> core.Cell:
    cell = core.find_cell(core.benchmark(), name)
    conf = copy.deepcopy(cell.config)
    y = conf["yaml"]
    y["MODEL"]["IMAGE_SIZE"] = [64, 64]
    y["MODEL"]["HEATMAP_SIZE"] = [16, 16]
    y["TRAIN"]["DTYPE"] = dtype
    ex = y["MODEL"]["EXTRA"]
    if y["MODEL"]["NAME"] == "pose_hrnet":
        for s in ("STAGE2", "STAGE3", "STAGE4"):
            n = ex[s]["NUM_BRANCHES"]
            ex[s]["NUM_CHANNELS"] = [4, 8, 16, 32][:n]
            ex[s]["NUM_BLOCKS"] = [1] * n
            ex[s]["NUM_MODULES"] = 1
    else:
        ex["NUM_LAYERS"] = 18
        ex["NUM_DECONV_FILTERS"] = [16, 16, 16]
    y["DATASET"]["WARP_BUCKET"] = [96, 96]
    cell.config = conf
    tr = copy.deepcopy(cell.traffic)
    tr["batch"] = 4
    if tr["kind"] == "advmix_train":
        tr["pool_batches"] = 3
        tr["source_hw"] = [80, 96]
    else:
        tr["pool_batches"] = 2
        tr["passes"] = tr["passes"][::9]
        tr["check_batches"] = 3
    tr["trace"] = {"skip": 1, "active": 2}
    cell.traffic = tr
    return cell


def run(cell: core.Cell, seed: int = 2 ** 31 + 17, seconds: float = 0.5,
        trace: bool = False) -> dict:
    from portbench import run as run_mod

    return run_mod.run_cell(cell, seed, seconds, trace, torch.device("cpu"),
                            time.time())
