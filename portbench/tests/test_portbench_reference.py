"""The plain reference against the program at a tiny size on the CPU: each
reference model's forward, and whole runs of each cell in float32, where
the program and the reference must agree to rounding."""

from __future__ import annotations

import pytest
import torch

from portbench.kinds import common
from portbench.reference import models
from portbench.tests.tiny import run, tiny_cell

CELLS = ["w32-advmix-b32", "r50-advmix-b32", "w32-sweep-b128"]


@pytest.mark.parametrize("cell", ["w32-advmix-b32", "r50-advmix-b32"])
def test_pose_forward_matches_the_program(cell):
    c = tiny_cell(cell)
    from portbench import core

    cfg = core.port_config(c.config)
    w = common.seeded_weights(c.config["yaml"]["MODEL"], (64, 64), 5,
                              torch.device("cpu"), True)
    port = common.port_pose(cfg, w["d"], torch.device("cpu"))
    ref = models.pose_net(c.config["yaml"]["MODEL"])
    ref.load_state_dict(w["d"])
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(1))
    for mode in ("eval", "train"):
        getattr(port, mode)()
        getattr(ref, mode)()
        torch.testing.assert_close(port(x), ref(x), rtol=1e-5, atol=1e-5)
    g = common.port_generator(w["g"], torch.device("cpu"))
    rg = models.Unet()
    rg.load_state_dict(w["g"])
    v = torch.randn(2, 9, 64, 64, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(g(v), rg(v), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cell", CELLS)
def test_float32_run_agrees_with_the_reference(cell):
    r = run(tiny_cell(cell))
    assert r["correct"], r["checks"]
    for name, c in r["checks"].items():
        assert c["value"] < 1e-5, (name, c)
    assert r["attempted"] >= 1
    assert {"setup_s"} < set(r["metrics"])


def test_traced_run_reports_per_layer_metrics_only():
    r = run(tiny_cell("w32-advmix-b32"), trace=True)
    assert "setup_s" not in r["metrics"]
    assert "train_host_ms" in r["metrics"]
    assert r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(r)[-1] == "checks"


def test_result_line_keys():
    r = run(tiny_cell("w32-sweep-b128"))
    assert list(r)[:3] == ["correct", "attempted", "failed"]
    assert {"metrics", "device", "checks"} <= set(r)
    assert list(r)[-1] == "checks"
