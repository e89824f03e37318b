"""--stylize_image, --sp_style and DEBUG.DEBUG in the port against the JAX
package: `ConcatDataset` over an MPII set and its stylized copy
(`build_stylized_dataset`), the AdvMix preprocessor with the `is_style`
exemption, and the train entry point (`tools/train.main --device cpu`) with
both options and with the debug dumps on.

Tolerances: samples and `is_style` equal for the same RandomState; the
preprocessor's targets equal and its f32 views within 1 ulp with the JAX
package's draws replayed (the primitives are bit-exact on integer images,
tests/test_torch_augment.py, but XLA compiles the JAX preprocessor's
normalization as a whole and rounds some quotients the other way).
"""

import logging
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from advmix_tpu.config import load_config as jax_load_config
from advmix_tpu.data import build_dataset as jax_build_dataset
from advmix_tpu.data.datasets import ConcatDataset as JaxConcatDataset
from advmix_tpu.data.datasets import build_stylized_dataset as jax_stylized
from advmix_tpu.engine import trainer as jax_trainer
from advmix_tpu_torch.config import load_config
from advmix_tpu_torch.data import (ConcatDataset, Loader, build_dataset,
                                   build_stylized_dataset)
from advmix_tpu_torch.engine import trainer
from advmix_tpu_torch.ops import augment as TA
from advmix_tpu_torch.tools import train as train_tool

from test_torch_augment import (_jax_autoaugment_draws, _jax_gridmask_draws,
                                _tensors)
from test_torch_mpii import _cfg, write_mpii

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """An MPII set of 6 people and its stylized copy of 5 (other pixels,
    other annotations) under `stylize_image_mpii` beside it."""
    base = tmp_path_factory.mktemp("data")
    root = str(base / "mpii")
    write_mpii(root, np.random.RandomState(20), sets=("train", "valid"))
    write_mpii(str(base / "stylize_image_mpii"), np.random.RandomState(21),
               n=5, sets=("train", "valid"))
    return root


def _both(root, is_train):
    over = {"DATASET.PROB_HALF_BODY": 0.5}
    cfg = _cfg(load_config, root, **over)
    jcfg = _cfg(jax_load_config, root, **over)
    ds = ConcatDataset([build_dataset(cfg, is_train),
                        build_stylized_dataset(cfg, is_train)],
                       style_tags=[0.0, 1.0])
    jds = JaxConcatDataset([jax_build_dataset(jcfg, is_train),
                            jax_stylized(jcfg, is_train)],
                           style_tags=[0.0, 1.0])
    return ds, jds


@pytest.mark.parametrize("is_train", [True, False])
def test_concat_dataset_samples_equal_jax(roots, is_train):
    ds, jds = _both(roots, is_train)
    assert len(ds) == len(jds) == 11
    assert ds.datasets[1].records[0]["image"].startswith(
        os.path.join(os.path.dirname(roots), "stylize_image_mpii"))
    for i in range(len(ds)):
        for fn in ("get_sample", "get_raw_sample"):
            got = getattr(ds, fn)(i, np.random.RandomState(i))
            want = getattr(jds, fn)(i, np.random.RandomState(i))
            want.pop("instance_index")
            assert got.keys() == want.keys()
            assert got["is_style"] == np.float32(i >= 6)
            for k in got:
                np.testing.assert_array_equal(np.asarray(got[k]),
                                              np.asarray(want[k]), err_msg=k)
    with pytest.raises(IndexError):
        ds.get_sample(len(ds), np.random.RandomState(0))
    # validation goes to the first child, as the JAX package's does
    calls = []
    ds.datasets[0].evaluate = lambda *a, **k: calls.append(a) or ({}, 0.0)
    assert ds.evaluate("cfg", "preds", "out") == ({}, 0.0)
    assert calls == [("cfg", "preds", "out")]


def test_concat_batches_carry_is_style(roots):
    ds, _ = _both(roots, True)
    batch = next(iter(Loader(ds, 11, num_threads=1)))
    assert batch["is_style"].dtype == np.float32
    np.testing.assert_array_equal(batch["is_style"], [0] * 6 + [1] * 5)


def test_sp_style_preprocessor_matches_jax(roots, monkeypatch):
    """make_preprocessor(sp_style=True) on a batch of the concatenation:
    the stylized rows' three views are the clean one, the others get
    AutoAugment and GridMask, all equal to the JAX package's with its draws
    replayed."""
    ds, _ = _both(roots, True)
    host = next(iter(Loader(ds, 11, num_threads=1)))
    cfg = _cfg(load_config, roots)
    jcfg = _cfg(jax_load_config, roots)
    key = jax.random.PRNGKey(3)
    b, (w, h) = 11, cfg.MODEL.IMAGE_SIZE
    k_aa, k_gm = jax.random.split(key)
    draws = dict(autoaugment=_tensors(_jax_autoaugment_draws(k_aa, b)),
                 gridmask=_tensors(_jax_gridmask_draws(k_gm, b, h, w)))
    monkeypatch.setattr(TA, "draw_advmix_views", lambda *a, **k: draws)

    jprep = jax_trainer.make_preprocessor(jcfg, advmix=True, train=True,
                                          sp_style=True)
    prep = trainer.make_preprocessor(cfg, advmix=True,
                                     device=torch.device("cpu"),
                                     sp_style=True)
    assert prep.required == jprep.required == ("image", "joints",
                                               "joints_vis", "is_style")
    want = jprep({k: jnp.asarray(host[k]) for k in jprep.required}, key)
    got = prep({k: torch.from_numpy(host[k]) for k in prep.required},
               torch.Generator().manual_seed(0))
    views = got["views"].numpy().transpose(0, 2, 3, 1)
    np.testing.assert_array_max_ulp(views, np.asarray(want["views"]),
                                    maxulp=1)
    np.testing.assert_array_equal(
        got["target"].numpy(), np.asarray(want["target"]).transpose(0, 3, 1,
                                                                    2))
    for row in range(6, 11):  # stylized: three copies of the clean view
        np.testing.assert_array_equal(views[row, ..., 3:6],
                                      views[row, ..., :3])
        np.testing.assert_array_equal(views[row, ..., 6:9],
                                      views[row, ..., :3])
    assert any(not np.array_equal(views[r, ..., 3:6], views[r, ..., :3])
               for r in range(6))


def test_missing_is_style_is_zero_filled_with_one_warning(monkeypatch):
    batch = {"image": np.zeros((3, 8, 8, 3), np.uint8)}
    monkeypatch.delattr(trainer._host_inputs, "_warned_is_style",
                        raising=False)
    # a handler on the port's logger itself: `create_logger`, which other
    # tests in this process may have run, stops its propagation to pytest
    records = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = records.append
    trainer.logger.addHandler(handler)
    try:
        for _ in range(2):
            out = trainer._host_inputs(batch, ("image", "is_style"))
            np.testing.assert_array_equal(out["is_style"], np.zeros(3))
    finally:
        trainer.logger.removeHandler(handler)
    assert sum("lacks 'is_style'" in r.getMessage() for r in records) == 1
    with pytest.raises(KeyError):
        trainer._host_inputs(batch, ("image", "warp_matrix"))


# ---------------------------------------------------------------------------
# the train entry point
# ---------------------------------------------------------------------------

DEBUG_FILES = ("gt", "pred", "hm_gt", "hm_pred")


def _tiny_yaml(tmp_path, root):
    """PoseResNet-18 at 64x64 on the MPII set: 11 train samples with the
    stylized copy, 3 iterations of batch 3 (2 without it)."""
    cfg = dict(
        OUTPUT_DIR=str(tmp_path / "output"), LOG_DIR=str(tmp_path / "log"),
        PRINT_FREQ=2, AUTO_RESUME=False,
        DATASET=dict(DATASET="mpii", ROOT=root, TRAIN_SET="train",
                     TEST_SET="valid"),
        MODEL=dict(NAME="pose_resnet", NUM_JOINTS=16, IMAGE_SIZE=[64, 64],
                   HEATMAP_SIZE=[16, 16], SIGMA=2,
                   EXTRA=dict(NUM_LAYERS=18, NUM_DECONV_LAYERS=3,
                              NUM_DECONV_FILTERS=[16, 16, 16],
                              NUM_DECONV_KERNELS=[4, 4, 4],
                              FINAL_CONV_KERNEL=1, DECONV_WITH_BIAS=False,
                              HE_INIT=True)),
        TRAIN=dict(BATCH_SIZE_PER_GPU=3, END_EPOCH=1, SHUFFLE=False),
        TEST=dict(BATCH_SIZE_PER_GPU=4),
        DEBUG=dict(DEBUG=True, SAVE_BATCH_IMAGES_GT=True,
                   SAVE_BATCH_IMAGES_PRED=True, SAVE_HEATMAPS_GT=True,
                   SAVE_HEATMAPS_PRED=True),
    )
    path = str(tmp_path / "tiny_mpii.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


@pytest.mark.parametrize("mode", ["advmix", "standard"])
def test_train_cli_stylize_sp_style_and_debug_dumps(roots, tmp_path,
                                                    monkeypatch, mode):
    """--stylize_image --sp_style and DEBUG.DEBUG on the CPU: the training
    set is the concatenation, the preprocessor takes `is_style`, and the
    dumps land every PRINT_FREQ iterations in training and in validation,
    and on no other."""
    monkeypatch.chdir(tmp_path)
    seen = {}
    real = trainer.make_preprocessor

    def spy(*a, **k):
        seen.update(k)
        return real(*a, **k)

    monkeypatch.setattr(trainer, "make_preprocessor", spy)
    flags = (["--advmix", "--sample_times", "3", "--downsamples", "4",
              "--stylize_image", "--sp_style", "1"] if mode == "advmix"
             else [])
    out = train_tool.main(["--cfg", _tiny_yaml(tmp_path, roots), "--device",
                           "cpu", *flags])
    n_iter = 3 if mode == "advmix" else 2
    assert len(out["history"]) == 1 and len(out["history"][0]) == n_iter
    assert seen["sp_style"] is (mode == "advmix")
    debug = tmp_path / "output" / "mpii" / "pose_resnet" / "debug"
    names = set(os.listdir(debug))
    want = {f"val_0_{f}.jpg" for f in DEBUG_FILES}
    for i in range(0, n_iter, 2):  # PRINT_FREQ 2: iterations 0 and 2
        want |= {f"train_0_{i}_{f}.jpg" for f in DEBUG_FILES}
        if mode == "advmix":
            want |= {f"train_0_{i}_mixed_{f}.jpg" for f in DEBUG_FILES}
    assert names == want
    assert all((debug / n).stat().st_size > 0 for n in names)
    shutil.rmtree(debug)
