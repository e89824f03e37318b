"""The multi-slice mesh: `parallel.dist.get_mesh(num_slices=2)` on four gloo
ranks against the flat four-rank group and the JAX steps on
`get_mesh(4, num_slices=2)`.

A ("dcn", "data") mesh is pure data parallelism (`mesh.py:21-59`): the
batch shards over both axes in the flattened rank order, so rank r keeps
rows [r*b, (r+1)*b) as on the flat group, and every collective reduces
within "data", then across "dcn", dividing by the whole world. Four ranks
take two iterations (SGD, global batch 4, one row each) of the standard
step and the AdvMix step on PoseResNet-18 64x64 in float64, the AdvMix step
also with TRAIN.CROSS_REPLICA_BN, once over the flat group and once over
the mesh, from the seeded weights of tests/test_torch_dist_steps.py. The
mesh's leaves must equal the flat run's and the JAX step's within 1e-9 of
the update's range (the hierarchical sum only reorders the additions), as
`tests/test_engine.py:346-373` holds the JAX mesh to the flat one. The
collectives' own results on the mesh equal the flat group's.
"""

import numpy as np
import pytest

from advmix_tpu.parallel import get_mesh as jax_get_mesh
from advmix_tpu_torch.parallel.dist import launch

from test_torch_dist_steps import TOL, _case, _port_batches, _rel_err, \
    _short, jax_run
from torch_dist_worker import mesh_step_cases, rank_sys_path

CASES = ["train:float64:local", "advmix:float64:local",
         "advmix:float64:cross"]


@pytest.fixture(scope="module", autouse=True)
def _rank_sys_path():
    with rank_sys_path():
        yield


@pytest.fixture(scope="module")
def four_ranks():
    from concurrent.futures import ThreadPoolExecutor

    cases = {name: _case(name) for name in CASES}
    port = {n: dict(c, batches=_port_batches(c)) for n, c in cases.items()}
    for c in port.values():
        c.pop("jcfg")
    with ThreadPoolExecutor(1) as ex:  # the ranks are other processes
        ranks = ex.submit(launch, mesh_step_cases, ["cpu"] * 4, port, 2)
        want = {n: jax_run(c, jax_get_mesh(4, num_slices=2))
                for n, c in cases.items()}
        return cases, ranks.result(), want


def _check(res, want, case):
    start = _short(case["flat_d"])
    for coll in ("params", "batch_stats"):
        err = _rel_err(res["d"], want["d"], start, coll)
        assert err < TOL["float64"], (coll, err)
    if "g" in want:
        err = _rel_err(res["g"], want["g"], _short(case["flat_g"]), "params")
        assert err < TOL["float64"], ("G", err)
    for m, ref in zip(res["metrics"], want["metrics"]):
        for k in ref:
            assert abs(m[k] - ref[k]) <= TOL["float64"] * max(1.0,
                                                              abs(ref[k]))


@pytest.mark.parametrize("name", CASES)
def test_multi_slice_mesh_equals_flat_group(four_ranks, name):
    cases, got, _ = four_ranks
    res = got[name]
    assert res["mesh"]["ranks_equal"]
    _check(res["mesh"], res["flat"], cases[name])


@pytest.mark.parametrize("name", CASES)
def test_multi_slice_mesh_matches_jax(four_ranks, name):
    cases, got, want = four_ranks
    _check(got[name]["mesh"], want[name], cases[name])


def test_mesh_layout_and_collectives(four_ranks):
    """Slice s holds ranks [2s, 2s+2) ("data"); "dcn" joins the ranks of
    one position in their slices (`mesh.py:48`'s reshape); the means, the
    BN statistics and the cross-replica mean's gradient are the flat
    group's."""
    _, got, _ = four_ranks
    for r, layout in enumerate(got["layout"]):
        assert layout["data"] == [2 * (r // 2), 2 * (r // 2) + 1]
        assert layout["dcn"] == [r % 2, r % 2 + 2]
    flat, mesh = got["collectives"]["flat"], got["collectives"]["mesh"]
    for a, b in zip(flat, mesh):
        for k in ("a", "b", "mean", "var", "grad"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-15, atol=0)
    assert flat[0]["a"] == [2.5] * 3  # the mean of 1, 2, 3, 4
