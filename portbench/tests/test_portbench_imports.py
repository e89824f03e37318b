"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program. Top-level module names are
compared whole: `advmix_tpu_torch` begins with `advmix_tpu`."""

from __future__ import annotations

import os
import sys

import pytest

from portbench import core
from portbench.reference import models

FILES = sorted(os.path.join(d, f) for d, _, fs in os.walk(core.HERE)
               for f in fs if f.endswith(".py"))


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: os.path.relpath(p, core.ROOT))
def test_no_jax_anywhere(path):
    assert not models.imports_of(path) & set(core.FORBIDDEN)


@pytest.mark.parametrize(
    "path", [f for f in FILES if os.sep + "reference" + os.sep in f],
    ids=lambda p: os.path.relpath(p, core.ROOT))
def test_reference_is_plain(path):
    found = models.imports_of(path)
    assert "advmix_tpu_torch" not in found
    assert found <= models.PLAIN_IMPORTS
    assert not models.PLAIN_IMPORTS & (set(core.FORBIDDEN)
                                       | {"advmix_tpu_torch", "portbench"})


def test_forbidden_names_are_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "advmix_tpu_torch_probe", sys)
    assert "advmix_tpu_torch_probe" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "advmix_tpu.ops", sys)
    assert "advmix_tpu" in core.forbidden_modules()
