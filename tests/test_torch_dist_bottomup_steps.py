"""The port's bottom-up steps on two ranks against the JAX steps on a
2-device mesh: the plain and the AdvMix bottom-up step on the narrowed
HigherHRNet of tests/test_torch_bottomup_steps.py in float64, with
per-replica and with cross-replica BatchNorm, two iterations of a global
batch of 4 (two images per rank) with valid masks, held to 1e-9 of the
update's range as tests/test_torch_dist_steps.py (whose machinery this
file uses) holds the top-down steps. A file of its own: the JAX side's
float64 compiles take most of its time, and the suite's workers run the
two files side by side."""

import pytest

from test_torch_dist_steps import check_case, run_two_ranks
from torch_dist_worker import rank_sys_path

CASES = ["bottomup:float64:local", "bottomup:float64:cross",
         "bottomup_advmix:float64:local", "bottomup_advmix:float64:cross"]


@pytest.fixture(scope="module", autouse=True)
def _rank_sys_path():
    with rank_sys_path():
        yield


@pytest.fixture(scope="module")
def two_ranks():
    return run_two_ranks(CASES)


@pytest.mark.parametrize("name", CASES)
def test_two_ranks_match_jax_mesh_of_two(two_ranks, name):
    check_case(two_ranks, name)
