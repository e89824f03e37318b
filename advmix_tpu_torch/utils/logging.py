"""Logging, output-dir taxonomy, meters and the metric table.

Port of `advmix_tpu/utils/logging.py` (reference `lib/utils/utils.py:22-75`
and `lib/core/function.py:364-398`): output dir
{OUTPUT_DIR}/{dataset}/{model}/{cfg_name}, robustness runs under a separate
`<OUTPUT_DIR>_robustness` tree, file + console logging.
"""

from __future__ import annotations

import logging
import os
import time
from pathlib import Path

LOGGER_NAME = "advmix_tpu_torch"


def create_logger(cfg, cfg_name: str, phase: str = "train",
                  main: bool = True):
    """Returns (logger, final_output_dir, tb_log_dir). A rank other than
    the main one (`main=False`) writes no log file and logs only
    warnings."""
    root_output_dir = Path(cfg.OUTPUT_DIR or "output")
    dataset = cfg.DATASET.DATASET
    model = cfg.MODEL.NAME
    cfg_name = os.path.basename(cfg_name).split(".")[0]

    if cfg.TEST.TEST_ROBUST:
        root_output_dir = Path(str(root_output_dir) + "_robustness")
        final_output_dir = root_output_dir / dataset / model / "test_corruption"
    else:
        final_output_dir = root_output_dir / dataset / model / cfg_name
    final_output_dir.mkdir(parents=True, exist_ok=True)

    time_str = time.strftime("%Y-%m-%d-%H-%M")
    final_log_file = final_output_dir / f"{cfg_name}_{time_str}_{phase}.log"

    logger = logging.getLogger(LOGGER_NAME)
    logger.setLevel(logging.INFO if main else logging.WARNING)
    logger.propagate = False
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter("%(asctime)-15s %(message)s")
    handlers = [logging.StreamHandler()]
    if main:
        handlers.append(logging.FileHandler(str(final_log_file)))
    for h in handlers:
        h.setFormatter(fmt)
        logger.addHandler(h)

    tb_log_dir = (
        Path(cfg.LOG_DIR or "log") / dataset / model / f"{cfg_name}_{time_str}"
    )
    tb_log_dir.mkdir(parents=True, exist_ok=True)
    return logger, str(final_output_dir), str(tb_log_dir)


class AverageMeter:
    """Running value/avg meter (`lib/core/function.py:383-398`)."""

    def __init__(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count if self.count else 0.0


def print_name_value(logger, name_value, full_arch_name: str):
    """Markdown-style metric table (`lib/core/function.py:364-381`)."""
    names = list(name_value.keys())
    values = list(name_value.values())
    logger.info("| Arch " + " ".join(f"| {n}" for n in names) + " |")
    logger.info("|---" * (len(values) + 1) + "|")
    if len(full_arch_name) > 15:
        full_arch_name = full_arch_name[:8] + "..."
    logger.info(
        "| " + full_arch_name + " "
        + " ".join(f"| {v:.3f}" for v in values) + " |"
    )
