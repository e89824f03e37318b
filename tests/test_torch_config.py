"""The port's config system against the JAX package's: every experiment
YAML gives the same tree in both (exact equality: the code is the same
and nothing is computed)."""

import glob
import os
from types import SimpleNamespace

import pytest

from advmix_tpu.config import get_default_config as jax_default
from advmix_tpu.config import load_config as jax_load_config
from advmix_tpu.config import update_config as jax_update_config
from advmix_tpu_torch.config import get_default_config, load_config, \
    update_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(os.path.relpath(p, ROOT) for p in
               glob.glob(os.path.join(ROOT, "experiments", "**", "*.yaml"),
                         recursive=True))


def test_yamls_found():
    assert len(YAMLS) >= 10


@pytest.mark.parametrize("yaml_path", YAMLS)
def test_yaml_tree_matches_jax(yaml_path):
    path = os.path.join(ROOT, yaml_path)
    assert load_config(path).to_dict() == jax_load_config(path).to_dict()


def test_update_config_matches_jax():
    args = SimpleNamespace(
        cfg=os.path.join(ROOT, "experiments/coco/hrnet/w32_256x192_advmix.yaml"),
        opts=["TEST.BATCH_SIZE_PER_GPU", "64", "MODEL.EXTRA.USE_SCAN",
              "False", "DATASET.ROOT", "/data/coco"],
        modelDir="", logDir="", dataDir="", test_robust=True, severity=0)
    port, ref = get_default_config(), jax_default()
    update_config(port, args)
    jax_update_config(ref, args)
    assert port.to_dict() == ref.to_dict()
    assert port.TEST.BATCH_SIZE_PER_GPU == 64
    with pytest.raises(KeyError):
        port.defrost()
        port.merge_from_list(["TEST.NO_SUCH_KEY", "1"])
