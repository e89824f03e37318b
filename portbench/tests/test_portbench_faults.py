"""The output check fails what it must: each fault that a cell can have,
planted under the timed path of a whole run, and the control (the reference
in float8 put in the program's place). At a tiny size on the CPU, against
the committed limits."""

from __future__ import annotations

import pytest
import torch

from portbench import calibrate, faults
from portbench.tests.tiny import run, tiny_cell

TRAIN = ["w32-advmix-b32", "r50-advmix-b32"]


@pytest.mark.parametrize("cell", TRAIN)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "g_unchanged",
                                   "single_bn_update"])
def test_train_fault_is_not_correct(cell, fault):
    with faults.planted(fault):
        r = run(tiny_cell(cell))
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", ["half_batch", "answer"])
def test_sweep_fault_is_not_correct(fault):
    with faults.planted(fault):
        r = run(tiny_cell("w32-sweep-b128"), seconds=1.0)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", TRAIN + ["w32-sweep-b128"])
def test_control_is_not_correct(cell):
    """The control (the reference with its convolutions in float8, put in
    the program's place) fails the cell's limits."""
    c = tiny_cell(cell)
    rows = calibrate.readings(c, [], [3], [], 1.0, torch.device("cpu"),
                              emit=lambda _: None)
    (ctl,) = [r["numbers"] for r in rows if r["side"] == "control"]
    assert any(ctl[k] > lim for k, lim in c.limits.items()), ctl


def test_faults_restore_the_program():
    from advmix_tpu_torch.engine import steps

    before = steps.make_advmix_step, steps.make_eval_step
    with faults.planted("half_batch"):
        assert steps.make_advmix_step is not before[0]
    assert (steps.make_advmix_step, steps.make_eval_step) == before
