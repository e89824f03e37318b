"""The port's spatial partitioning (advmix_tpu_torch/parallel/spatial.py)
against the JAX package's `make_spatial_forward` and the port's own
unsharded forward.

gloo ranks on the CPU (`parallel.dist.launch`, tests/torch_dist_worker.py)
each hold their block of an NCHW batch (batch rows over "data", GSPMD's
ceil-split of the image rows over "model") and return the full-height
outputs of their batch rows. Both packages load the same seeded numpy
weights (`models/convert.py`), with BN statistics calibrated so every
layer's output is O(1):

- PoseResNet-18 at 64x64 (strided convs, the max pool, the transposed-conv
  head) on (data 1, model 4): its deepest level has 2 rows, so two of the
  four shards there are empty; and on (data 2, model 2);
- the narrowed HigherHRNet of tests/test_torch_higher_hrnet.py (nearest
  upsampling in the fuse layers, the deconv head, both scales) on (1, 2).

Each is held in f32 to the JAX function on `get_mesh(8, model_parallel=4)`
(conftest's virtual devices) within JAX's own rtol 2e-4, atol 5e-5
(tests/test_spatial.py), and to the port's unsharded f32 forward within the
same; in float64 to the port's unsharded forward within 1e-12 of the
output's range. A halo row left out (a planted fault) breaks the match; an
op outside the allowlist, and BatchNorm in training mode, raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from advmix_tpu.models.pose_resnet import PoseResNet as JaxPoseResNet
from advmix_tpu.parallel import get_mesh as jax_get_mesh
from advmix_tpu.parallel import make_spatial_forward as jax_spatial_forward
from advmix_tpu.parallel.spatial import spatial_sharding
from advmix_tpu_torch.config import get_default_config
from advmix_tpu_torch.models import get_pose_net
from advmix_tpu_torch.parallel import dist as pdist
from advmix_tpu_torch.parallel.spatial import row_split, shard_slices

from test_torch_higher_hrnet import jax_higher, seeded_higher
from torch_dist_worker import rank_sys_path, spatial_case_and_refusals, \
    spatial_cases
from torch_port_util import calibrate_bn, random_variables, unflatten, \
    variable_shapes

RTOL, ATOL = 2e-4, 5e-5  # tests/test_spatial.py
F64_TOL = 1e-12
J, FILTERS = 4, (16, 16, 16)


@pytest.fixture(scope="module", autouse=True)
def _rank_sys_path():
    with rank_sys_path():
        yield


def resnet_cfg():
    cfg = get_default_config()
    cfg.MODEL.NAME = "pose_resnet"
    cfg.MODEL.NUM_JOINTS = J
    cfg.MODEL.IMAGE_SIZE = [64, 64]
    cfg.MODEL.HEATMAP_SIZE = [16, 16]
    cfg.MODEL.EXTRA.NUM_LAYERS = 18
    cfg.MODEL.EXTRA.NUM_DECONV_LAYERS = 3
    cfg.MODEL.EXTRA.NUM_DECONV_FILTERS = list(FILTERS)
    cfg.MODEL.EXTRA.NUM_DECONV_KERNELS = [4, 4, 4]
    cfg.MODEL.EXTRA.DECONV_WITH_BIAS = False
    cfg.MODEL.EXTRA.FINAL_CONV_KERNEL = 1
    cfg.freeze()
    return cfg


def _jax_forward(model, flat, x_nchw):
    """The JAX spatial forward (`tests/test_spatial.py`'s mesh), NCHW."""
    mesh = jax_get_mesh(8, model_parallel=4)
    fwd = jax_spatial_forward(model, mesh)
    xs = jax.device_put(jnp.asarray(x_nchw.transpose(0, 2, 3, 1)),
                        spatial_sharding(mesh))
    out = jax.device_get(fwd(unflatten(flat), xs))
    outs = [out] if not isinstance(out, (list, tuple)) else out
    return [np.asarray(o).transpose(0, 3, 1, 2) for o in outs]


@pytest.fixture(scope="module")
def resnet():
    """The PoseResNet cases on four ranks, in one launch: (1, 4), (2, 2),
    and (1, 4) with the planted fault; and the JAX outputs."""
    from concurrent.futures import ThreadPoolExecutor

    cfg = resnet_cfg()
    jmodel = JaxPoseResNet(num_layers=18, num_joints=J,
                           num_deconv_filters=FILTERS)
    flat = random_variables(variable_shapes(jmodel, (64, 64)), seed=3)
    rng = np.random.RandomState(4)
    flat = calibrate_bn(flat, get_pose_net(cfg),
                        rng.randn(4, 64, 64, 3).astype(np.float32))
    x = rng.randn(4, 3, 64, 64)
    cases = {name: dict(cfg=cfg, flat=flat, x=x, model_parallel=mp,
                        mutation=name == "fault")
             for name, mp in (("1x4", 4), ("2x2", 2), ("fault", 4))}
    with ThreadPoolExecutor(1) as ex:  # the ranks are other processes
        ranks = ex.submit(pdist.launch, spatial_cases, ["cpu"] * 4, cases)
        want = _jax_forward(jmodel, flat, x.astype(np.float32))
        return ranks.result(), want


@pytest.fixture(scope="module")
def higher():
    """The narrowed HigherHRNet on (1, 2) and the refusals, two ranks."""
    from concurrent.futures import ThreadPoolExecutor

    from test_torch_higher_hrnet import higher_cfg

    _, flat = seeded_higher()
    x = np.random.RandomState(1).randn(2, 3, 64, 64)
    case = dict(cfg=higher_cfg(), flat=flat, x=x, model_parallel=2)
    with ThreadPoolExecutor(1) as ex:
        ranks = ex.submit(pdist.launch, spatial_case_and_refusals,
                          ["cpu"] * 2, case)
        want = _jax_forward(jax_higher(), flat, x.astype(np.float32))
        return ranks.result(), want


def _rows_of(want, data_index, n_data):
    b = want.shape[0] // n_data
    return want[data_index * b:(data_index + 1) * b]


def check(per_rank, want_jax, n_data):
    for r in per_rank:
        for g, w in zip(r["float32"]["got"], r["float32"]["want"]):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
        for g, w in zip(r["float32"]["got"], want_jax):
            np.testing.assert_allclose(
                g, _rows_of(w, r["data_index"], n_data), rtol=RTOL,
                atol=ATOL)
        for g, w in zip(r["float64"]["got"], r["float64"]["want"]):
            assert g.dtype == np.float64 and g.shape == w.shape
            err = np.abs(g - w).max() / np.abs(w).max()
            assert err < F64_TOL, err
        assert np.abs(r["float64"]["want"][0]).mean() > 0.05  # not dead


@pytest.mark.parametrize("name,n_data", [("1x4", 1), ("2x2", 2)])
def test_resnet_matches_jax_and_unsharded(resnet, name, n_data):
    got, want = resnet
    per_rank = got[name]
    assert len(per_rank) == 4
    check(per_rank, want, n_data)
    # a row block of 64 / (4 / n_data) rows, every rank exchanging halos
    k = 4 // n_data
    assert {r["shard"] for r in per_rank} == {(4 // n_data, 3, 64 // k, 64)}
    assert all(r["exchanges"] > 0 for r in per_rank)


def test_mesh_layout_is_the_jax_reshape(resnet):
    """model group d holds ranks [d*k, (d+1)*k); rank r is in data group
    r % k (`mesh.py:44`'s reshape of the device list)."""
    got, _ = resnet
    for name, k in (("1x4", 4), ("2x2", 2)):
        for r, res in enumerate(got[name]):
            d = r // k
            assert res["layout"]["model"] == list(range(d * k, d * k + k))
            assert res["layout"]["data"] == list(range(r % k, 4, k))
            assert res["data_index"] == d


def test_higher_hrnet_both_scales(higher):
    got, want = higher
    per_rank = got["forward"]
    assert len(per_rank) == 2 and len(want) == 2
    assert [g.shape for g in per_rank[0]["float32"]["got"]] == [
        (2, 10, 16, 16), (2, 5, 32, 32)]
    check(per_rank, want, 1)


def test_planted_halo_fault_breaks_the_match(resnet):
    """One halo row left out, once per rank, moves the output far past
    the float64 tolerance."""
    got, _ = resnet
    for r in got["fault"]:
        g, w = r["float64"]["got"][0], r["float64"]["want"][0]
        assert np.abs(g - w).max() / np.abs(w).max() > 1e6 * F64_TOL


def test_ops_outside_the_allowlist_raise(higher):
    got, _ = higher
    for msgs in got["refusals"]:
        assert "avg_pool2d" in msgs["avg_pool2d"]
        assert "batch_norm" in msgs["train_bn"]


def test_ceil_split_shard_shapes():
    """The JAX test's (4, 64, 64, 3) batch on a (2, 4) mesh: every shard
    (2, 16, 64, 3), here (2, 3, 16, 64); a height that does not divide
    leaves the last shards short or empty, as GSPMD pads."""
    shape = (4, 3, 64, 64)
    for d in range(2):
        for m in range(4):
            bs, rs = shard_slices(shape, (d, 2), (m, 4))
            blk = np.zeros(shape)[bs, :, rs]
            assert blk.shape == (2, 3, 16, 64)
            assert (bs.start, rs.start) == (2 * d, 16 * m)
    assert [row_split(2, 4, j) for j in range(4)] == [(0, 1), (1, 2),
                                                      (2, 2), (2, 2)]
    assert [row_split(10, 4, j) for j in range(4)] == [(0, 3), (3, 6),
                                                       (6, 9), (9, 10)]
    with pytest.raises(ValueError):
        shard_slices((3, 3, 8, 8), (0, 2), (0, 1))


def test_get_mesh_keeps_the_jax_asserts():
    with pytest.raises(AssertionError, match="mutually exclusive"):
        pdist.get_mesh(4, num_slices=2, model_parallel=2)
    with pytest.raises(AssertionError):
        pdist.get_mesh(4, model_parallel=3)
    with pytest.raises(AssertionError):
        pdist.get_mesh(6, num_slices=4)
    with pytest.raises(RuntimeError, match="process group"):
        pdist.get_mesh(4, model_parallel=2)  # no group in this process
