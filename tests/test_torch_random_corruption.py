"""`--random_corruption` and the hazards of the card's machine.

- The port's `make_random_corruption_fn`, given the JAX package's
  per-image branch indices (replayed from its key splits), gives the JAX
  function's per-image outputs: bit-close (|diff| <= 1e-3 on [0, 255]) for
  the key-free branches; for the random branches the JAX package's draws
  fed to the port's apply of the same (type, severity) give the JAX
  output to the same tolerance, and the port's own draws stay in range.
- `python -m advmix_tpu_torch.tools.train --random_corruption --device cpu`
  trains an epoch of the synthetic smoke YAML.
- With cv2 and PIL blocked, as the card's machine may lack them, every
  benchmark corruption in both forms and `render_batch` still run.
- `corrupt` sums its convolutions and matmuls in f64, so TF32 never
  applies even when the caller allows it, and it leaves the caller's
  settings as they were.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import advmix_tpu.ops.corruptions as J
import advmix_tpu_torch.ops.corruptions as T
from advmix_tpu.engine.trainer import \
    make_random_corruption_fn as jax_random_corruption_fn
from advmix_tpu.parallel import get_mesh
from advmix_tpu_torch.engine.trainer import make_random_corruption_fn
from torch_corruption_util import image, jax_draws

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "experiments/synthetic/res18_64x64_smoke.yaml")
ENV = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="",
           OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")


def jax_branches(key, n: int):
    """The JAX function's per-image (chunk 1) branch index and draw key on
    a one-device mesh: fold in the device index, split per image, split
    each image's key into (branch key, draw key)."""
    keys = jax.random.split(jax.random.fold_in(key, 0), n)
    out = []
    for kk in keys:
        k_c, k_s = jax.random.split(kk)
        out.append((int(jax.random.randint(k_c, (), 0, 75)), k_s))
    return out


def jax_per_image(x, branches):
    """What the JAX function's 75-branch `lax.switch` computes for each
    image: `corrupt(x_i, type, severity, draw key)`. Evaluated eagerly:
    compiling the switch takes ~100 s on the CPU."""
    return np.concatenate([np.asarray(J.corrupt(
        jnp.asarray(x[i:i + 1]), J.BENCHMARK_CORRUPTIONS[br // 5],
        br % 5 + 1, k_s)) for i, (br, k_s) in enumerate(branches)])


def test_jax_branch_replay_matches_the_compiled_function():
    """`jax_branches` + `jax_per_image` against the JAX function itself, on
    a key whose 4 images all draw key-free or cheap branches."""
    x = image(43, (4, 16, 16, 3))
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax_random_corruption_fn(get_mesh(1), chunk=1)(
        jnp.asarray(x), key))
    np.testing.assert_allclose(jax_per_image(x, jax_branches(key, 4)), want,
                               rtol=0, atol=1e-4)


def test_random_corruption_matches_jax_per_image():
    x = image(40, (12, 32, 24, 3))
    key = next(k for k in (jax.random.PRNGKey(s) for s in range(100))
               if len({b // 5 for b, _ in jax_branches(k, 12)}) >= 6)
    branches = jax_branches(key, 12)
    want = jax_per_image(x, branches)
    fn = make_random_corruption_fn()
    assert fn.n_branches == 75
    got = fn(torch.from_numpy(x), torch.Generator().manual_seed(0),
             branches=[b for b, _ in branches])
    assert got.shape == x.shape
    kinds = set()
    for i, (br, k_s) in enumerate(branches):
        name, sev = T.BENCHMARK_CORRUPTIONS[br // 5], br % 5 + 1
        xi = x[i:i + 1]
        if name in T.DRAWS:
            kinds.add("random")
            replay = T.CORRUPTIONS[name](torch.from_numpy(xi), sev,
                                        **jax_draws(name, xi, sev, k_s))
            np.testing.assert_allclose(replay.numpy(), want[i:i + 1],
                                       rtol=0, atol=1e-3, err_msg=name)
            assert 0 <= float(got[i].min()) and float(got[i].max()) <= 255
        else:
            kinds.add("key-free")
            np.testing.assert_allclose(got[i].numpy(), want[i], rtol=0,
                                       atol=1e-3, err_msg=name)
    assert kinds == {"random", "key-free"}


def test_random_corruption_draws_per_image():
    """10 images: 10 branch draws, each applied to one image, every branch
    a benchmark type in its random form, and the same generator seed gives
    the same batch."""
    x = torch.from_numpy(image(41, (10, 32, 24, 3)))
    fn = make_random_corruption_fn()
    seen = []
    real = T.corrupt

    def spy(img, name, severity, generator=None, exact_render=False):
        seen.append((img.shape[0], name, severity, exact_render))
        return real(img, name, severity, generator, exact_render)

    import advmix_tpu_torch.engine.trainer as trainer

    orig = trainer.corrupt
    trainer.corrupt = spy
    try:
        a = fn(x, torch.Generator().manual_seed(3))
        b = fn(x, torch.Generator().manual_seed(3))
    finally:
        trainer.corrupt = orig
    assert torch.equal(a, b)
    assert [n for n, *_ in seen] == [1] * 20
    assert seen[:10] == seen[10:]
    assert all(name in T.BENCHMARK_CORRUPTIONS and 1 <= s <= 5 and not ex
               for _, name, s, ex in seen)


def test_train_cli_with_random_corruption(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "advmix_tpu_torch.tools.train", "--cfg", SMOKE,
         "--device", "cpu", "--random_corruption", "DATASET.SYNTH_LENGTH",
         "16", "PRINT_FREQ", "1"], cwd=str(tmp_path), env=ENV,
        capture_output=True, text=True, timeout=300)
    log = proc.stderr + proc.stdout
    assert proc.returncode == 0, log[-3000:]
    assert "--random_corruption: a random benchmark corruption" in log
    assert "Epoch: [0][1/2]" in log and "| pose_resnet | " in log
    out = tmp_path / "output/synthetic/pose_resnet/res18_64x64_smoke"
    assert (out / "final_state").is_file()


BLOCKED = r"""
import sys


class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("cv2", "PIL"):
            raise ImportError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, Block())
import numpy as np
import torch

from advmix_tpu_torch.ops import corruptions as C
from advmix_tpu_torch.tools.make_datasets import render_batch

x = torch.from_numpy(np.random.RandomState(0).randint(
    0, 256, (2, 40, 32, 3)).astype(np.float32))
g = torch.Generator().manual_seed(0)
n = 0
for name in C.BENCHMARK_CORRUPTIONS:
    for s in range(1, 6):
        for exact in (False, True):
            out = C.corrupt(x, name, s, g, exact_render=exact)
            assert out.shape == x.shape and torch.isfinite(out).all(), name
            n += 1
    out5 = render_batch(x.to(torch.uint8), name)
    assert out5.shape == (5,) + x.shape and out5.dtype == torch.uint8
leaked = [m for m in sys.modules if m.split(".")[0] in ("cv2", "PIL")]
assert not leaked, leaked
print(n)
"""


def test_benchmark_corruptions_run_without_cv2_and_pil():
    proc = subprocess.run([sys.executable, "-c", BLOCKED], cwd=ROOT, env=ENV,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.strip()) == 15 * 5 * 2


@pytest.mark.parametrize("name", ["gaussian_blur", "defocus_blur",
                                  "glass_blur", "elastic_transform",
                                  "pixelate", "jpeg_compression", "frost"])
def test_corrupt_keeps_tf32_out(monkeypatch, name):
    """Under a caller's cudnn.flags(allow_tf32=True) and 'high' matmul
    precision, every convolution and matmul inside `corrupt` takes f64
    operands, which TF32 (an f32 mode) never touches; and the caller's
    settings are left as they were."""
    cudnn = torch.backends.cudnn
    seen = []
    for mod, fn in ((torch.nn.functional, "conv2d"), (torch, "einsum"),
                    (torch, "matmul")):
        real = getattr(mod, fn)

        def spy(*a, real=real, fn=fn, **k):
            seen.extend((fn, t.dtype) for t in a
                        if isinstance(t, torch.Tensor))
            return real(*a, **k)

        monkeypatch.setattr(mod, fn, spy)
    before = torch.get_float32_matmul_precision()
    x = torch.from_numpy(image(42))
    try:
        torch.set_float32_matmul_precision("high")
        with cudnn.flags(enabled=cudnn.enabled, allow_tf32=True):
            T.release_constants()
            T.corrupt(x, name, 5, exact_render=True)
            assert cudnn.allow_tf32
            assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(before)
    assert seen, name
    assert all(dtype == torch.float64 for _, dtype in seen), seen
