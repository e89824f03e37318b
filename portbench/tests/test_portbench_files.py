"""BENCHMARK.json and the files it names: the file's shape, and that
a cell, a traffic mix, a configuration or a per-layer metric is found by
name, so that a later change adds one by adding files alone."""

from __future__ import annotations

import importlib
import json
import os
import re
import shutil

import pytest
import yaml

from portbench import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = core.benchmark()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_bounds():
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            assert e["name"] not in names
            names.add(e["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert len(setup) == 1 and "workloads" not in setup[0]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(cell):
    c = core.find_cell(BENCH, cell)
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert c.per_layer
    kind = core.kind_module(c.traffic)
    assert hasattr(kind, "CellRun")
    assert c.limits and all(isinstance(v, (int, float))
                            for v in c.limits.values())


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_has_a_reader(metric):
    m = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    assert callable(core.metric_reader(metric).read)
    e2e = {e["name"]: e for e in BENCH["end_to_end"]}
    assert m["moves"] in e2e
    for cell in m["workloads"]:
        assert "workloads" not in e2e[m["moves"]] \
            or cell in e2e[m["moves"]]["workloads"]


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_holds_the_yaml_it_runs(conf):
    with open(os.path.join(core.ROOT, conf["file"])) as f:
        data = json.load(f)
    with open(os.path.join(core.ROOT, data["repo_yaml"])) as f:
        assert data["yaml"] == yaml.safe_load(f)
    # every group that differs from the source is named, with how it does
    assert data["reduced"] == conf["reduced"]
    assert set(data["changed_from_source"]) - {"note"} == set(conf["reduced"])
    assert set(conf["reduced"]) <= set(data["yaml"])
    assert conf["source"] == data["source"]


def test_a_cell_added_by_files_alone(tmp_path):
    base = tmp_path / "portbench"
    for sub in ("configs", "traffic", "limits"):
        shutil.copytree(os.path.join(core.HERE, sub), base / sub)
    traffic = json.loads((base / "traffic" / "advmix-b32.json").read_text())
    traffic["batch"] = 48
    (base / "traffic" / "advmix-b48.json").write_text(json.dumps(traffic))
    (base / "limits" / "w32-advmix-b48.json").write_text(
        (base / "limits" / "w32-advmix-b32.json").read_text())
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "w32-advmix-b48",
                               "config": "hrnet-w32-256x192",
                               "traffic": "advmix-b48", "chips": 1,
                               "why": "a dummy cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "w32-advmix-b32" in m.get("workloads", ()):
            m["workloads"].append("w32-advmix-b48")
    cell = core.find_cell(bench, "w32-advmix-b48", base=str(base))
    assert cell.traffic["batch"] == 48
    same = core.find_cell(BENCH, "w32-advmix-b32")
    assert [m["name"] for m in cell.end_to_end] == \
        [m["name"] for m in same.end_to_end]
    assert [m["name"] for m in cell.per_layer] == \
        [m["name"] for m in same.per_layer]
    assert importlib.import_module(
        f"portbench.kinds.{cell.traffic['kind']}").CellRun
