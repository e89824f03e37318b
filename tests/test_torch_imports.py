"""The port stands alone: every module of advmix_tpu_torch (the
data-parallel `parallel/` among them), chip_smoke.py and the module the
multi-rank tests' ranks import, tests/torch_dist_worker.py, import with
`jax`, its libraries and `advmix_tpu` blocked;
and without a card the entry points refuse to run unless asked for the
CPU."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W32 = os.path.join(ROOT, "experiments/coco/hrnet/w32_256x192_advmix.yaml")
NO_CARD = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")

BLOCKED_IMPORTS = r"""
import importlib, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "advmix_tpu")


class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, Block())
import advmix_tpu_torch

names = [m.name for m in pkgutil.walk_packages(advmix_tpu_torch.__path__,
                                               "advmix_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert "advmix_tpu_torch.parallel.dist" in names
import chip_smoke

sys.path.insert(0, "tests")
import torch_dist_worker

leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", BLOCKED_IMPORTS], cwd=ROOT,
                          env=NO_CARD, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.strip()) >= 36  # every module was walked


def test_entry_point_without_card_raises(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "advmix_tpu_torch.tools.validate", "--cfg",
         W32], cwd=str(tmp_path), env=NO_CARD, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
    assert not os.listdir(tmp_path)  # it stopped before writing anything


@pytest.mark.parametrize("tool,args", [
    ("train", ["--cfg", W32, "--advmix", "--sample_times", "3"]),
    ("bench", []),
])
def test_train_entry_points_without_card_raise(tmp_path, tool, args):
    proc = subprocess.run(
        [sys.executable, "-m", f"advmix_tpu_torch.tools.{tool}", *args],
        cwd=str(tmp_path), env=NO_CARD, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
    assert not os.listdir(tmp_path)


NEW_MODULES = ["models.unet", "ops.augment", "engine.optim", "engine.state",
               "engine.checkpoint", "tools.train", "tools.bench"]


@pytest.mark.parametrize("name", NEW_MODULES)
def test_training_modules_name_their_jax_counterpart(name):
    """Each module of the training slice exists, documents which JAX module
    it ports, and mentions no import of it."""
    path = os.path.join(ROOT, "advmix_tpu_torch", *name.split(".")) + ".py"
    src = open(path).read()
    assert "advmix_tpu/" in src.split('"""')[1] or "bench.py" in src or \
        "tools/train.py" in src
    for line in src.splitlines():
        assert not line.startswith(("import jax", "from jax", "import flax",
                                    "import optax", "from advmix_tpu ",
                                    "from advmix_tpu.", "import advmix_tpu "))


SWEEP_MODULES = [("ops.corruptions", "advmix_tpu/ops/corruptions.py"),
                 ("tools.test_corruption", "tools/test_corruption.py"),
                 ("tools.make_datasets", "tools/make_datasets.py")]


@pytest.mark.parametrize("name,counterpart", SWEEP_MODULES)
def test_sweep_modules_name_their_jax_counterpart(name, counterpart):
    """Each module of the corruption slice documents which JAX module it
    ports, and imports nothing of JAX, cv2 or PIL at module level."""
    path = os.path.join(ROOT, "advmix_tpu_torch", *name.split(".")) + ".py"
    src = open(path).read()
    assert counterpart in src.split('"""')[1]
    for line in src.splitlines():
        assert not line.startswith(("import jax", "from jax", "import cv2",
                                    "from PIL", "import PIL",
                                    "from advmix_tpu ", "from advmix_tpu.",
                                    "import advmix_tpu "))


@pytest.mark.parametrize("tool,args", [
    ("test_corruption", ["--cfg", W32, "--on_the_fly"]),
    ("make_datasets", ["--dataset_root", "."]),
])
def test_sweep_entry_points_without_card_raise(tmp_path, tool, args):
    proc = subprocess.run(
        [sys.executable, "-m", f"advmix_tpu_torch.tools.{tool}", *args],
        cwd=str(tmp_path), env=NO_CARD, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
    assert not os.listdir(tmp_path)


def test_chip_smoke_without_card_fails(tmp_path):
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                          cwd=str(tmp_path), env=NO_CARD, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


FAMILY_MODULES = [("utils.zipreader", "advmix_tpu/utils/zipreader.py"),
                  ("utils.vis", "advmix_tpu/utils/vis.py"),
                  ("evaluation.mpii_eval",
                   "advmix_tpu/evaluation/mpii_eval.py"),
                  ("engine.heatmap_debug",
                   "advmix_tpu/engine/heatmap_debug.py")]


@pytest.mark.parametrize("name,counterpart", FAMILY_MODULES)
def test_family_modules_name_their_jax_counterpart(name, counterpart):
    """Each module that the slice of the other top-down families and eval
    options added documents which JAX module it copies, and imports nothing
    of JAX or of the JAX package, and not cv2 at module level (the port's
    modules import it where they decode or draw)."""
    path = os.path.join(ROOT, "advmix_tpu_torch", *name.split(".")) + ".py"
    src = open(path).read()
    assert counterpart in src.split('"""')[1]
    for line in src.splitlines():
        assert not line.startswith(("import jax", "from jax", "import cv2",
                                    "from advmix_tpu ", "from advmix_tpu.",
                                    "import advmix_tpu "))


BOTTOMUP_MODULES = [("models.higher_hrnet", "advmix_tpu/models/higher_hrnet.py"),
                    ("ops.ae", "advmix_tpu/ops/ae.py"),
                    ("data.masks", "advmix_tpu/data/masks.py"),
                    ("data.bottomup", "advmix_tpu/data/bottomup.py"),
                    ("evaluation.grouping",
                     "advmix_tpu/evaluation/grouping.py")]


@pytest.mark.parametrize("name,counterpart", BOTTOMUP_MODULES)
def test_bottomup_modules_name_their_jax_counterpart(name, counterpart):
    """Each module of the bottom-up slice documents which JAX module it
    ports or copies, and imports nothing of JAX or of the JAX package, and
    not cv2 at module level."""
    path = os.path.join(ROOT, "advmix_tpu_torch", *name.split(".")) + ".py"
    src = open(path).read()
    assert counterpart in src.split('"""')[1]
    for line in src.splitlines():
        assert not line.startswith(("import jax", "from jax", "import cv2",
                                    "from advmix_tpu ", "from advmix_tpu.",
                                    "import advmix_tpu "))


HIGHER = os.path.join(ROOT, "experiments/coco/higher_hrnet/w32_512_advmix.yaml")
OCHUMAN = os.path.join(ROOT,
                       "experiments/ochuman/higher_hrnet/w32_512_advmix.yaml")


@pytest.mark.parametrize("tool,args", [
    ("validate", ["--cfg", OCHUMAN]),
    ("train", ["--cfg", HIGHER, "--advmix", "--sample_times", "3"]),
    ("test_corruption", ["--cfg", HIGHER, "--on_the_fly"]),
    ("bench", ["--cfg", HIGHER, "--batch", "12"]),
])
def test_bottomup_entry_points_without_card_raise(tmp_path, tool, args):
    proc = subprocess.run(
        [sys.executable, "-m", f"advmix_tpu_torch.tools.{tool}", *args],
        cwd=str(tmp_path), env=NO_CARD, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
    assert not os.listdir(tmp_path)


SERVING_MODULES = [("ops.quant", "advmix_tpu/ops/quant.py"),
                   ("ops.int8_conv", "advmix_tpu/ops/quant.py"),
                   ("tools.export", "tools/export.py"),
                   ("tools.serve", "tools/serve.py"),
                   ("tools.serving_bench", "tools/serving_bench.py")]


@pytest.mark.parametrize("name,counterpart", SERVING_MODULES)
def test_int8_and_serving_modules_name_their_jax_counterpart(name,
                                                             counterpart):
    """Each module of the int8 and serving slice documents which JAX module
    it ports, and imports neither jax nor the JAX package (nor flax or
    orbax), at module level or inside a function."""
    path = os.path.join(ROOT, "advmix_tpu_torch", *name.split(".")) + ".py"
    src = open(path).read()
    assert counterpart in src.split('"""')[1]
    for line in src.splitlines():
        assert not line.strip().startswith((
            "import jax", "from jax", "import flax", "from flax",
            "import orbax", "from advmix_tpu ", "from advmix_tpu.",
            "import advmix_tpu ", "import advmix_tpu.")), line


@pytest.mark.parametrize("tool,args", [
    ("export", ["--cfg", W32]),
    ("serve", ["--export_dir", "."]),
    ("serve_check", ["--export_dir", "."]),
    ("serving_bench", ["--cfg", W32]),
])
def test_serving_entry_points_without_card_raise(tmp_path, tool, args):
    proc = subprocess.run(
        [sys.executable, "-m", f"advmix_tpu_torch.tools.{tool}", *args],
        cwd=str(tmp_path), env=NO_CARD, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
    assert not os.listdir(tmp_path)


SLICE8_MODULES = [("parallel.spatial", "advmix_tpu/parallel/spatial.py"),
                  ("parallel.dist", "advmix_tpu/parallel/mesh.py"),
                  ("utils.profiling", "advmix_tpu/utils/profiling.py"),
                  ("utils.summary", "advmix_tpu/utils/summary.py"),
                  ("tools.profile", "tools/profile.py"),
                  ("tools.hbm_peak", "tools/hbm_peak.py"),
                  ("tools.loader_bench", "tools/loader_bench.py"),
                  ("tools.parity_check", "tools/parity_check.py")]


@pytest.mark.parametrize("name,counterpart", SLICE8_MODULES)
def test_spatial_and_tooling_modules_name_their_jax_counterpart(
        name, counterpart):
    """Each module of the spatial, mesh and tooling slice documents which
    JAX module it ports, and imports neither jax nor the JAX package (nor
    flax), at module level or inside a function."""
    path = os.path.join(ROOT, "advmix_tpu_torch", *name.split(".")) + ".py"
    src = open(path).read()
    assert counterpart in src.split('"""')[1]
    for line in src.splitlines():
        assert not line.strip().startswith((
            "import jax", "from jax", "import flax", "from flax",
            "from advmix_tpu ", "from advmix_tpu.", "import advmix_tpu ",
            "import advmix_tpu.")), line


@pytest.mark.parametrize("tool,args", [
    ("profile", ["--cfg", W32, "--advmix", "--sample_times", "3"]),
    ("hbm_peak", []),
    ("parity_check", ["--cfg", W32, "--ckpt", "w.pth"]),
])
def test_tooling_entry_points_without_card_raise(tmp_path, tool, args):
    proc = subprocess.run(
        [sys.executable, "-m", f"advmix_tpu_torch.tools.{tool}", *args],
        cwd=str(tmp_path), env=NO_CARD, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
    assert not os.listdir(tmp_path)


SCRIPTS = os.path.join(ROOT, "advmix_tpu_torch", "scripts")


def _code_lines(path: str) -> list:
    """The lines of a script that are neither comments nor a Python
    module's docstring."""
    src = open(path).read()
    if path.endswith(".py"):
        import ast

        doc = ast.get_docstring(ast.parse(src), clean=False)
        src = src.replace(f'"""{doc}"""', "", 1) if doc else src
    return [ln for ln in src.splitlines()
            if ln.strip() and not ln.strip().startswith("#")]


@pytest.mark.parametrize("name", sorted(os.listdir(SCRIPTS)))
def test_scripts_call_only_the_port(name):
    """No file of the port's shell surface calls the JAX package's
    `tools/*.py` or `scripts/*`, names `advmix_tpu`, imports jax or edits
    sys.path; the shell scripts run Python only as `python -m
    advmix_tpu_torch.tools.<tool>`, `-m advmix_tpu_torch.scripts.
    demo_summary` or a here-document, whose imports are the port's."""
    import re

    path = os.path.join(SCRIPTS, name)
    if os.path.isdir(path):  # __pycache__
        return
    assert name.endswith((".sh", ".py")), name
    lines = _code_lines(path)
    for line in lines:
        assert not re.search(r"(?<![\w/])(tools|scripts)/", line), line
        assert not re.search(r"\badvmix_tpu\b(?!_torch)", line), line
        assert not re.search(r"\b(import|from) (jax|flax|orbax)\b", line), \
            line
        assert "sys.path" not in line, line
    if name.endswith(".sh"):
        text = "\n".join(lines)
        calls = re.findall(r'"(?:\$PY|\$\{PYTHON:-python\})"\s+(-m\s+\S+|-)\s',
                           text)
        assert len(calls) == len(
            re.findall(r'"(?:\$PY|\$\{PYTHON:-python\})"', text))
        for call in calls:
            assert call == "-" or re.fullmatch(
                r"-m\s+advmix_tpu_torch\.(tools\.\w+|scripts\.demo_summary)",
                call), call
        assert "python " not in text.replace("${PYTHON:-python}", "")
