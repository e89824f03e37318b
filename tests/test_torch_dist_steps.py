"""The port's steps on two ranks against the JAX steps on a 2-device mesh.

Two gloo ranks on the CPU (`parallel.dist.launch`,
`tests/torch_dist_worker.py`) each take their half of a global batch of 4, rows [0, 2) and [2, 4): the
rows `shard_map`'s `P("data")` gives the two devices of `get_mesh(2)`
(conftest's virtual CPU devices). Both sides start from the same seeded
numpy weights (`models/convert.py`) and take two iterations with SGD:

- the standard step on PoseResNet-18 64x64 in f32;
- the AdvMix step on PoseResNet-18 D and a tiny UNet G in float64;
- (tests/test_torch_dist_bottomup_steps.py, with this file's machinery) the
  bottom-up plain and AdvMix steps on the narrowed HigherHRNet of
  tests/test_torch_bottomup_steps.py in float64;

each with per-replica BatchNorm (the default, as the reference's
DataParallel) and with TRAIN.CROSS_REPLICA_BN. Per collection, the trained
parameters and BN statistics of D (and G) must agree in float64 within
1e-9 of the update's range (the largest change of a leaf), and in f32
within 1e-4 of the leaves' range, as tests/test_torch_unet.py holds one
device: there the JAX BatchNorm's E[x^2] - E[x]^2 and torch's two-pass
variance round apart through every layer (4.6e-3 of the update's range
for the f32 train step, measured here), while a skipped gradient or
statistics average moves the leaves by the update itself (~1e-3 of their
range). The losses agree within the same share of their magnitude. Every
rank ends with the same weights, bit for bit, and the AdvMix step's
planted `single_bn_update` fault still breaks the match.
"""

import flax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax import enable_x64

from advmix_tpu.config import get_default_config as jax_default_config
from advmix_tpu.config import load_config as jax_load_config
from advmix_tpu.engine import steps as jax_steps
from advmix_tpu.engine.state import AdvMixState as JaxAdvMixState
from advmix_tpu.engine.state import PoseState as JaxPoseState
from advmix_tpu.models import get_pose_net as jax_get_pose_net
from advmix_tpu.models.unet import UnetGenerator as JaxUnet
from advmix_tpu.parallel import get_mesh
from advmix_tpu_torch.config import get_default_config
from advmix_tpu_torch.parallel.dist import launch

from test_torch_bottomup_steps import block_mask
from test_torch_higher_hrnet import SHALLOW, SIZE, higher_cfg, jax_higher, \
    seeded_higher
from test_torch_higher_hrnet import J as BU_J
from test_torch_train_steps import NGF, _cfg, _shapes
from torch_dist_worker import rank_sys_path, step_cases
from torch_port_util import random_variables, unflatten

GB = 4  # the global batch: two rows per rank
ALPHA, ADV_W = 0.3, 0.7
LR_D, LR_G = 0.01, 0.02
TOL = {"float64": 1e-9, "float32": 1e-4}
M, BU_DOWNS = 3, 4


@pytest.fixture(scope="module", autouse=True)
def _rank_sys_path():
    with rank_sys_path():
        yield


def _leaves(tree, coll):
    flat = flax.traverse_util.flatten_dict(flax.core.unfreeze(tree))
    return {f"{coll}/{k[-2]}/{k[-1]}": np.asarray(v) for k, v in flat.items()}


def _short(flat: dict) -> dict:
    return {f"{k.split('/')[0]}/" + "/".join(k.split("/")[-2:]): v
            for k, v in flat.items()}


def _with_cross(cfg, cross: bool):
    cfg = cfg.clone()
    cfg.defrost()
    cfg.TRAIN.CROSS_REPLICA_BN = cross
    cfg.freeze()
    return cfg


def _g_variables(num_downs, hw, seed):
    jg = JaxUnet(input_nc=9, num_downs=num_downs, ngf=NGF)
    return random_variables(_shapes(jg, jnp.zeros((1, hw, hw, 9))), seed)


def _resnet_case(kind, dtype, seed=5):
    cfg, jcfg = _cfg(get_default_config, "resnet"), _cfg(jax_default_config,
                                                         "resnet")
    jd = jax_get_pose_net(jcfg)
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    flat_d = random_variables(_shapes(jd, x), seed=11)
    rng = np.random.RandomState(seed)
    ch = 9 if kind == "advmix" else 3
    batches = [dict(image=rng.randn(GB, ch, 64, 64),
                    target=rng.rand(GB, 6, 16, 16),
                    target_weight=(rng.rand(GB, 6) > 0.2) * 1.0)
               for _ in range(2)]
    case = dict(kind=kind, cfg=cfg, jcfg=jcfg, flat_d=flat_d,
                batches=batches, lr_d=LR_D, num_downs=6)
    if kind == "advmix":
        case.update(flat_t=random_variables(_shapes(jd, x), seed=23),
                    flat_g=_g_variables(6, 64, 37))
    return _cast(case, dtype)


def _bottomup_case(kind, seed=7):
    _, flat_d = seeded_higher(11, extra=SHALLOW)
    rng = np.random.RandomState(seed)
    batches = []
    for _ in range(2):
        vis = (rng.rand(GB, M, BU_J) > 0.25) * 1.0
        vis[1, 2] = 0.0  # a padded person slot
        batches.append(dict(
            image=rng.randn(GB, 9 if kind == "bottomup_advmix" else 3,
                            SIZE, SIZE),
            joints=rng.uniform(2, SIZE - 2, (GB, M, BU_J, 2)),
            joints_vis=vis, mask=block_mask(rng, b=GB)))
    case = dict(kind=kind, cfg=higher_cfg(extra=SHALLOW),
                jcfg=higher_cfg(jax_load_config, extra=SHALLOW),
                flat_d=flat_d, batches=batches, lr_d=LR_D,
                num_downs=BU_DOWNS)
    if kind == "bottomup_advmix":
        case.update(flat_t=seeded_higher(23, extra=SHALLOW)[1],
                    flat_g=_g_variables(BU_DOWNS, SIZE, 37))
    return _cast(case, "float64")


def _cast(case, dtype):
    np_dt = np.dtype(dtype)
    for k in ("flat_d", "flat_t", "flat_g"):
        if k in case:
            case[k] = {p: v.astype(np_dt) for p, v in case[k].items()}
    case["batches"] = [{k: v.astype(np_dt) for k, v in b.items()}
                       for b in case["batches"]]
    case.update(dtype=dtype, lr_g=LR_G, alpha=ALPHA, adv_w=ADV_W, ngf=NGF)
    return case


def _jax_batch(kind, b):
    nhwc = lambda a: jnp.asarray(a.transpose(0, 2, 3, 1))  # noqa: E731
    key = "views" if "advmix" in kind else "image"
    if kind.startswith("bottomup"):
        return {key: nhwc(b["image"]), "joints": jnp.asarray(b["joints"]),
                "joints_vis": jnp.asarray(b["joints_vis"]),
                "mask": jnp.asarray(b["mask"])}
    return {key: nhwc(b["image"]), "target": nhwc(b["target"]),
            "target_weight": jnp.asarray(b["target_weight"])}


def _port_batches(case):
    key = "views" if "advmix" in case["kind"] else "image"
    return [{(key if k == "image" else k): v for k, v in b.items()}
            for b in case["batches"]]


def jax_run(case, mesh=None):
    """The JAX step of `case` on `mesh` (default a 2-device mesh): D's (and
    G's) leaves and the metrics after the case's iterations."""
    kind, jcfg = case["kind"], case["jcfg"]
    jdt = jnp.float64 if case["dtype"] == "float64" else jnp.float32
    with enable_x64(case["dtype"] == "float64"):
        jd = (jax_higher(dtype=jdt, extra=SHALLOW) if kind.startswith(
            "bottomup") else jax_get_pose_net(jcfg, dtype=jdt))
        vd = unflatten(case["flat_d"])
        tx_d = optax.sgd(case["lr_d"])
        mesh = get_mesh(2) if mesh is None else mesh
        if "advmix" in kind:
            jg = JaxUnet(input_nc=9, num_downs=case["num_downs"], ngf=NGF,
                         dtype=jdt)
            vt, pg = unflatten(case["flat_t"]), unflatten(
                case["flat_g"])["params"]
            tx_g = optax.sgd(case["lr_g"])
            state = JaxAdvMixState(
                params_d=vd["params"], batch_stats_d=vd["batch_stats"],
                opt_state_d=tx_d.init(vd["params"]), params_g=pg,
                opt_state_g=tx_g.init(pg), params_t=vt["params"],
                batch_stats_t=vt["batch_stats"],
                step=jnp.zeros((), jnp.int32))
            make = (jax_steps.make_advmix_step if kind == "advmix"
                    else jax_steps.make_bottomup_advmix_step)
            step = make(jd, jg, tx_d, tx_g, jcfg, mesh, alpha=ALPHA,
                        adv_loss_weight=ADV_W)
        else:
            state = JaxPoseState(params=vd["params"],
                                 batch_stats=vd["batch_stats"],
                                 opt_state=tx_d.init(vd["params"]),
                                 step=jnp.zeros((), jnp.int32))
            make = (jax_steps.make_train_step if kind == "train"
                    else jax_steps.make_bottomup_step)
            step = make(jd, tx_d, jcfg, mesh)
        metrics = []
        for b in case["batches"]:
            state, m = step(state, _jax_batch(kind, b))
            metrics.append({k: float(v) for k, v in m.items()})
        if "advmix" in kind:
            d = _leaves(state.params_d, "params")
            d.update(_leaves(state.batch_stats_d, "batch_stats"))
            return dict(d=d, g=_leaves(state.params_g, "params"),
                        metrics=metrics)
        d = _leaves(state.params, "params")
        d.update(_leaves(state.batch_stats, "batch_stats"))
        return dict(d=d, metrics=metrics)


def _case(name):
    kind, dtype, bn = name.split(":")
    if kind.startswith("bottomup"):
        case = _bottomup_case(kind)
    else:
        case = _resnet_case(kind, dtype)
    cross = bn == "cross"
    case["cfg"] = _with_cross(case["cfg"], cross)
    case["jcfg"] = _with_cross(case["jcfg"], cross)
    return case


def run_two_ranks(names, mutated=None) -> tuple:
    """The named cases (and, with `mutated`, that case with the planted
    `single_bn_update` fault, as "mutation") on two gloo ranks in one
    launch, while the JAX side runs here. Returns the cases as built, the
    ranks' results and the JAX results, by name."""
    from concurrent.futures import ThreadPoolExecutor

    cases = {name: _case(name) for name in names}
    port = {n: dict(c, batches=_port_batches(c)) for n, c in cases.items()}
    for c in port.values():
        c.pop("jcfg")
    if mutated is not None:
        port["mutation"] = dict(port[mutated], mutation="single_bn_update")
    with ThreadPoolExecutor(1) as ex:  # the ranks are other processes
        ranks = ex.submit(launch, step_cases, ["cpu", "cpu"], port)
        want = {n: jax_run(c) for n, c in cases.items()}
        return cases, ranks.result(), want


def _rel_err(got: dict, want: dict, start: dict, coll: str,
             of_update: bool = True) -> float:
    """max |got - want| over the collection's leaves, over the largest
    change of a leaf (`of_update`) or the largest magnitude."""
    keys = [k for k in want if k.startswith(coll + "/")]
    assert keys and set(got) == set(want)
    w = {k: want[k].astype(np.float64) for k in keys}
    moved = max(float(np.abs(w[k] - start[k]).max()) for k in keys)
    assert moved > 1e-6, f"{coll} did not move"
    scale = moved if of_update else max(float(np.abs(v).max())
                                        for v in w.values())
    return max(float(np.abs(got[k] - w[k]).max()) for k in keys) / scale


def check_case(two_ranks, name):
    cases, got, wants = two_ranks
    case, res, want = cases[name], got[name], wants[name]
    tol, f64 = TOL[case["dtype"]], case["dtype"] == "float64"
    assert res["ranks_equal"], "the ranks' weights differ"
    # D ran in train mode once per iteration, twice under AdvMix
    per_it = 2 if "advmix" in case["kind"] else 1
    assert res["tracked"] == [per_it * len(case["batches"])]
    start_d = _short(case["flat_d"])
    for coll in ("params", "batch_stats"):
        err = _rel_err(res["d"], want["d"], start_d, coll, f64)
        assert err < tol, (coll, err)
    if "g" in want:
        err = _rel_err(res["g"], want["g"], _short(case["flat_g"]), "params",
                       f64)
        assert err < tol, ("G", err)
    for m, ref in zip(res["metrics"], want["metrics"]):
        assert set(m) == set(ref)
        for k in ref:
            assert abs(m[k] - ref[k]) <= tol * max(1.0, abs(ref[k])), \
                (k, m[k], ref[k])


CASES = ["train:float32:local", "train:float32:cross",
         "advmix:float64:local", "advmix:float64:cross"]
MUTATED = "advmix:float64:local"


@pytest.fixture(scope="module")
def two_ranks():
    return run_two_ranks(CASES, MUTATED)


@pytest.mark.parametrize("name", CASES)
def test_two_ranks_match_jax_mesh_of_two(two_ranks, name):
    check_case(two_ranks, name)


def test_planted_fault_still_breaks_the_match(two_ranks):
    """`_mutation="single_bn_update"` on two ranks moves D's statistics
    a thousand times past the clean comparison's tolerance."""
    cases, got, want = two_ranks
    err = _rel_err(got["mutation"]["d"], want[MUTATED]["d"],
                   _short(cases[MUTATED]["flat_d"]), "batch_stats")
    assert err > 1e3 * TOL["float64"]
