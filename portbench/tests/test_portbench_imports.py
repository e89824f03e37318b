"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program. Top-level module names are
compared whole: `advmix_tpu_torch` begins with `advmix_tpu`."""

from __future__ import annotations

import ast
import os
import sys

import pytest

from portbench import core

FILES = sorted(os.path.join(d, f) for d, _, fs in os.walk(core.HERE)
               for f in fs if f.endswith(".py"))


def top_level_imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant):
                names.add(arg.value.split(".")[0])
            elif isinstance(arg, ast.JoinedStr) and arg.values and \
                    isinstance(arg.values[0], ast.Constant):
                names.add(arg.values[0].value.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: os.path.relpath(p, core.ROOT))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & set(core.FORBIDDEN)


@pytest.mark.parametrize(
    "path", [f for f in FILES if os.sep + "reference" + os.sep in f],
    ids=lambda p: os.path.relpath(p, core.ROOT))
def test_reference_is_plain(path):
    found = top_level_imports(path)
    assert "advmix_tpu_torch" not in found
    assert found <= {"__future__", "collections", "contextlib", "copy",
                     "math", "os", "glob", "numpy", "scipy", "torch",
                     "cv2"}


def test_forbidden_names_are_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "advmix_tpu_torch_probe", sys)
    assert "advmix_tpu_torch_probe" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "advmix_tpu.ops", sys)
    assert "advmix_tpu" in core.forbidden_modules()
