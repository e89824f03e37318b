"""The port's eval data path against the JAX package's: the synthetic
marker dataset's samples, the Loader's batches (dataset order, a padded
tail with `_n` and `_indices`) and the synthetic PCK evaluation.

Tolerances: exact. Both packages draw the records from the same seeded
numpy stream, decode with the same cv2 calls and stack the same arrays.
"""

import os

import numpy as np
import pytest

from advmix_tpu.config import load_config as jax_load_config
from advmix_tpu.data import Loader as JaxLoader
from advmix_tpu.data import build_dataset as jax_build_dataset
from advmix_tpu_torch.config import load_config
from advmix_tpu_torch.data import Loader, build_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "experiments/synthetic/res18_64x64_smoke.yaml")


def _datasets(length):
    out = []
    for load in (jax_load_config, load_config):
        cfg = load()
        cfg.defrost()
        cfg.merge_from_file(SMOKE)
        cfg.DATASET.SYNTH_LENGTH = length
        cfg.freeze()
        out.append((cfg, (jax_build_dataset if load is jax_load_config
                          else build_dataset)(cfg, is_train=False)))
    return out


@pytest.mark.parametrize("length,batch", [(10, 4), (8, 4)])
def test_synthetic_batches_match_jax(length, batch):
    (_, jds), (_, ds) = _datasets(length)
    assert len(ds) == len(jds) == length
    assert ds.flip_pairs == jds.flip_pairs
    want = list(JaxLoader(jds, batch, shuffle=False))
    got = list(Loader(ds, batch))
    assert len(got) == len(want) == len(Loader(ds, batch))
    for g, w in zip(got, want):
        assert g["_n"] == w["_n"]
        np.testing.assert_array_equal(g["_indices"], w["_indices"])
        for k in ("image", "joints", "joints_vis", "center", "scale",
                  "score"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert list(g["image_path"]) == list(w["image_path"])


def test_synthetic_evaluate_matches_jax(tmp_path):
    (jcfg, jds), (cfg, ds) = _datasets(12)
    rng = np.random.RandomState(5)
    gt = np.stack([r["joints_3d"][:, :2] for r in ds.records])
    preds = np.concatenate(
        [gt + rng.randn(*gt.shape) * 15.0, rng.rand(*gt.shape[:2], 1)], -1)
    order = np.arange(len(ds))
    got = ds.evaluate(cfg, preds, str(tmp_path), indices=order)
    want = jds.evaluate(jcfg, preds, str(tmp_path), indices=order)
    assert got == want
    assert 0.0 < got[1] < 1.0  # the noise puts some joints past 20 px
    with pytest.raises(ValueError):
        ds.evaluate(cfg, preds, str(tmp_path), indices=order[::-1])
