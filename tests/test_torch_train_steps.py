"""The port's optimizers and train steps against the JAX package's.

Both sides start from the same seeded numpy weights (carried across by
`advmix_tpu_torch.models.convert`) and take the same pre-built batches, with
the augmentation bypassed. After two iterations the trained parameters, D's
BatchNorm statistics and the metrics are compared leaf by leaf:

- PoseResNet-18 in f32 within 2e-5 (absolute; the leaves are O(1) and move
  by O(1e-3) per step);
- a tiny HRNet in float64 on both sides within 1e-9: in f32 its ~100
  train-mode BatchNorms amplify the rounding of two different variance
  formulas beyond any fixed tolerance;
- the two planted faults of sequencing (`_mutation`) must break the match.

The config is that of tests/test_advmix_differential.py: ALPHA 0.3, ADV_W
0.7 and distinct learning rates, so that a transposed weight or a swapped
optimizer shows.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import enable_x64

from advmix_tpu.config import get_default_config as jax_default_config
from advmix_tpu.engine import optim as jax_optim
from advmix_tpu.engine.state import AdvMixState as JaxAdvMixState
from advmix_tpu.engine.state import PoseState as JaxPoseState
from advmix_tpu.engine.steps import make_advmix_step as jax_make_advmix_step
from advmix_tpu.engine.steps import make_train_step as jax_make_train_step
from advmix_tpu.models import get_pose_net as jax_get_pose_net
from advmix_tpu.models.unet import UnetGenerator as JaxUnet
from advmix_tpu.parallel import get_mesh
from advmix_tpu_torch.config import get_default_config
from advmix_tpu_torch.engine import optim
from advmix_tpu_torch.engine.state import AdvMixState, PoseState, \
    create_advmix_state, make_teacher
from advmix_tpu_torch.engine.steps import make_advmix_step, make_train_step
from advmix_tpu_torch.models import get_pose_net
from advmix_tpu_torch.models.convert import jax_to_torch_state_dict, \
    jax_unet_to_torch_state_dict, torch_to_jax_leaves
from advmix_tpu_torch.models.layers import set_compute_dtype
from advmix_tpu_torch.models.unet import UnetGenerator

from torch_port_util import TINY_EXTRA, random_variables, unflatten

# two threads: the suite runs several workers side by side
torch.set_num_threads(2)

B, J = 2, 6
ALPHA, ADV_W = 0.3, 0.7
LR_D, LR_G = 0.01, 0.02
NGF = 8


def _cfg(default, family):
    cfg = default()
    cfg.MODEL.NUM_JOINTS = J
    cfg.MODEL.INIT_WEIGHTS = False
    if family == "resnet":
        cfg.MODEL.NAME = "pose_resnet"
        cfg.MODEL.IMAGE_SIZE = [64, 64]
        cfg.MODEL.HEATMAP_SIZE = [16, 16]
        cfg.MODEL.EXTRA.NUM_LAYERS = 18
        cfg.MODEL.EXTRA.NUM_DECONV_LAYERS = 3
        cfg.MODEL.EXTRA.NUM_DECONV_FILTERS = [32, 32, 32]
        cfg.MODEL.EXTRA.NUM_DECONV_KERNELS = [4, 4, 4]
        cfg.MODEL.EXTRA.DECONV_WITH_BIAS = False
        cfg.MODEL.EXTRA.FINAL_CONV_KERNEL = 1
    else:
        cfg.MODEL.NAME = "pose_hrnet"
        # 64x64: the coarsest branch is 2x2, so its BatchNorms see 8 values
        # per channel at batch 2 (a 1x1 branch would leave them 2, and
        # amplify even f64 rounding past any tolerance)
        cfg.MODEL.IMAGE_SIZE = [64, 64]
        cfg.MODEL.HEATMAP_SIZE = [16, 16]
        # one block per branch: the step's f64 compile is most of the
        # test's time
        cfg.MODEL.EXTRA = {
            k: (dict(v, NUM_MODULES=1, NUM_BLOCKS=[1] * v["NUM_BRANCHES"])
                if isinstance(v, dict) else v) for k, v in TINY_EXTRA.items()}
    cfg.LOSS.USE_TARGET_WEIGHT = True
    cfg.LOSS.SMOOTH_L1 = False
    return cfg


def _shapes(model, x):
    tree = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x))
    flat = flax.traverse_util.flatten_dict(flax.core.unfreeze(tree))
    return {"/".join(k): v for k, v in flat.items()}


def _batches(rng, hw, hm, dtype, n=2):
    out = []
    for _ in range(n):
        out.append(dict(
            views=rng.randn(B, 9, hw, hw).astype(dtype),
            target=rng.rand(B, J, hm, hm).astype(dtype),
            target_weight=(rng.rand(B, J) > 0.2).astype(dtype)))
    return out


def _to_jax(batch, image_key="views"):
    return {image_key: jnp.asarray(batch["views"].transpose(0, 2, 3, 1)),
            "target": jnp.asarray(batch["target"].transpose(0, 2, 3, 1)),
            "target_weight": jnp.asarray(batch["target_weight"])}


def _to_torch(batch, image_key="views"):
    return {image_key: torch.from_numpy(batch["views"]),
            "target": torch.from_numpy(batch["target"]),
            "target_weight": torch.from_numpy(batch["target_weight"])}


def _jax_leaves(tree, coll):
    flat = flax.traverse_util.flatten_dict(flax.core.unfreeze(tree))
    return {f"{coll}/{k[-2]}/{k[-1]}": np.asarray(v) for k, v in flat.items()}


def _max_diff(got: dict, want: dict) -> float:
    assert set(got) == set(want) and got
    return max(float(np.abs(got[k].astype(np.float64)
                            - want[k].astype(np.float64)).max())
               for k in want)


class Setup:
    """Seeded weights for D, the teacher and G of one family, the JAX
    models, and the port's models loaded with the same weights."""

    def __init__(self, family: str, dtype):
        self.dtype = dtype
        self.jdtype = jnp.float64 if dtype == np.float64 else jnp.float32
        self.tdtype = torch.float64 if dtype == np.float64 else torch.float32
        self.jcfg = _cfg(jax_default_config, family)
        self.cfg = _cfg(get_default_config, family)
        self.hw = self.cfg.MODEL.IMAGE_SIZE[0]
        self.hm = self.cfg.MODEL.HEATMAP_SIZE[0]
        self.num_downs = 6
        self.jd = jax_get_pose_net(self.jcfg, dtype=self.jdtype)
        self.jg = JaxUnet(input_nc=9, num_downs=self.num_downs, ngf=NGF,
                          dtype=self.jdtype)
        x = jnp.zeros((1, self.hw, self.hw, 3), jnp.float32)
        shapes_d = _shapes(self.jd, x)
        self.flat_d = self._cast(random_variables(shapes_d, seed=11))
        self.flat_t = self._cast(random_variables(shapes_d, seed=23))
        self.flat_g = self._cast(random_variables(
            _shapes(self.jg, jnp.zeros((1, self.hw, self.hw, 9))), seed=37))
        self.batches = _batches(np.random.RandomState(5), self.hw, self.hm,
                                dtype)

    def _cast(self, flat):
        return {k: v.astype(self.dtype) for k, v in flat.items()}

    def port_d(self, flat):
        model = get_pose_net(self.cfg)
        model.load_state_dict(jax_to_torch_state_dict(flat, model))
        return model.to(self.tdtype)

    def port_g(self):
        model = UnetGenerator(input_nc=9, num_downs=self.num_downs, ngf=NGF)
        model.load_state_dict(jax_unet_to_torch_state_dict(self.flat_g,
                                                           model))
        return model.to(self.tdtype)

    def jax_advmix(self):
        vd, vt = unflatten(self.flat_d), unflatten(self.flat_t)
        pg = unflatten(self.flat_g)["params"]
        tx_d, tx_g = optax.sgd(LR_D), optax.sgd(LR_G)
        state = JaxAdvMixState(
            params_d=vd["params"], batch_stats_d=vd["batch_stats"],
            opt_state_d=tx_d.init(vd["params"]), params_g=pg,
            opt_state_g=tx_g.init(pg), params_t=vt["params"],
            batch_stats_t=vt["batch_stats"], step=jnp.zeros((), jnp.int32))
        step = jax_make_advmix_step(
            self.jd, self.jg, tx_d, tx_g, self.jcfg, get_mesh(1), alpha=ALPHA,
            adv_loss_weight=ADV_W, num_views=3)
        metrics = []
        for batch in self.batches:
            state, m = step(state, _to_jax(batch))
            metrics.append({k: float(v) for k, v in m.items()})
        leaves = _jax_leaves(state.params_d, "params")
        leaves.update(_jax_leaves(state.batch_stats_d, "batch_stats"))
        return leaves, _jax_leaves(state.params_g, "params"), metrics

    def port_advmix(self, mutation=None):
        d, g = self.port_d(self.flat_d), self.port_g()
        teacher = make_teacher(self.port_d(self.flat_t), self.tdtype)
        state = AdvMixState(
            d, torch.optim.SGD(d.parameters(), lr=LR_D), g,
            torch.optim.SGD(g.parameters(), lr=LR_G), teacher)
        step = make_advmix_step(state, self.cfg, alpha=ALPHA,
                                adv_loss_weight=ADV_W, _mutation=mutation)
        metrics = []
        for batch in self.batches:
            metrics.append({k: float(v) for k, v in
                            step(_to_torch(batch)).items()})
            w = step.last_mix_weights
            assert torch.allclose(w.sum(1), torch.ones_like(w[:, 0]))
        return state, torch_to_jax_leaves(d), torch_to_jax_leaves(g), metrics


def _check_advmix(setup, want, tol):
    want_d, want_g, want_m = want
    state, got_d, got_g, got_m = setup.port_advmix()
    # the run has teeth: D, its BN statistics and G all moved
    start = {k: v for k, v in setup.flat_d.items()}
    moved = {k: float(np.abs(want_d[f"{k.split('/')[0]}/"
                                    + "/".join(k.split("/")[-2:])]
                             - v).max()) for k, v in start.items()}
    assert max(v for k, v in moved.items() if k.startswith("params")) > 1e-4
    assert max(v for k, v in moved.items()
               if k.startswith("batch_stats")) > 1e-3
    assert _max_diff(want_g, {
        "params/" + "/".join(k.split("/")[-2:]): v
        for k, v in setup.flat_g.items()}) > 1e-6
    assert _max_diff(got_d, want_d) < tol
    assert _max_diff(got_g, want_g) < tol
    for got, ref in zip(got_m, want_m):
        assert set(got) == set(ref) == {"loss_d", "loss_g", "acc", "acc_cnt"}
        for k in ref:
            assert abs(got[k] - ref[k]) < tol, (k, got[k], ref[k])
    # D's BN layers saw two train-mode forwards per iteration
    tracked = [v for k, v in state.model_d.state_dict().items()
               if k.endswith("num_batches_tracked")]
    assert tracked and all(int(t) == 2 * len(setup.batches) for t in tracked)
    # the teacher never moved
    frozen = torch_to_jax_leaves(state.teacher)
    want_t = {f"{k.split('/')[0]}/" + "/".join(k.split("/")[-2:]): v
              for k, v in setup.flat_t.items()}
    assert _max_diff(frozen, want_t) == 0.0
    return want_d, want_g


@pytest.fixture(scope="module")
def resnet_f32():
    setup = Setup("resnet", np.float32)
    return setup, setup.jax_advmix()


@pytest.fixture(scope="module")
def hrnet_f64():
    with enable_x64(True):
        setup = Setup("hrnet", np.float64)
        return setup, setup.jax_advmix()


def test_advmix_two_iterations_resnet18_f32(resnet_f32):
    _check_advmix(*resnet_f32, tol=2e-5)


def test_advmix_two_iterations_tiny_hrnet_f64(hrnet_f64):
    _check_advmix(*hrnet_f64, tol=1e-9)


@pytest.mark.parametrize("family", ["resnet", "hrnet"])
@pytest.mark.parametrize("mutation",
                         ["single_bn_update", "stale_d_in_g_step"])
def test_advmix_differential_catches_mutation(request, family, mutation):
    """Each planted fault moves some leaf of D or G at least a thousand
    times past the tolerance of the clean comparison."""
    setup, (want_d, want_g, _) = request.getfixturevalue(
        "resnet_f32" if family == "resnet" else "hrnet_f64")
    tol = 2e-5 if family == "resnet" else 1e-9
    _, got_d, got_g, _ = setup.port_advmix(mutation)
    assert max(_max_diff(got_d, want_d), _max_diff(got_g, want_g)) > 1e3 * tol


@pytest.mark.parametrize("family,tol", [("resnet", 2e-5)])
def test_train_step_two_iterations(family, tol):
    """`make_train_step`, SGD without momentum, against the JAX step."""
    f64 = family == "hrnet"
    with enable_x64(f64):
        setup = Setup(family, np.float64 if f64 else np.float32)
        v = unflatten(setup.flat_d)
        tx = optax.sgd(LR_D)
        jstate = JaxPoseState(params=v["params"],
                              batch_stats=v["batch_stats"],
                              opt_state=tx.init(v["params"]),
                              step=jnp.zeros((), jnp.int32))
        jstep = jax_make_train_step(setup.jd, tx, setup.jcfg, get_mesh(1))
        want_m = []
        for batch in setup.batches:
            jb = _to_jax(batch, "image")
            jb["image"] = jb["image"][..., :3]
            jstate, m = jstep(jstate, jb)
            want_m.append({k: float(x) for k, x in m.items()})
        want = _jax_leaves(jstate.params, "params")
        want.update(_jax_leaves(jstate.batch_stats, "batch_stats"))
    d = setup.port_d(setup.flat_d)
    state = PoseState(d, torch.optim.SGD(d.parameters(), lr=LR_D))
    step = make_train_step(state, setup.cfg)
    for batch, ref in zip(setup.batches, want_m):
        tb = _to_torch(batch, "image")
        tb["image"] = tb["image"][:, :3].contiguous()
        got = {k: float(x) for k, x in step(tb).items()}
        for k in ref:
            assert abs(got[k] - ref[k]) < tol, (k, got[k], ref[k])
    assert state.step == 2
    assert _max_diff(torch_to_jax_leaves(d), want) < tol


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def _opt_cfg(default, name, nesterov=False):
    cfg = default()
    cfg.TRAIN.OPTIMIZER = name
    cfg.TRAIN.LR = 0.01
    cfg.TRAIN.WD = 0.01
    cfg.TRAIN.MOMENTUM = 0.9
    cfg.TRAIN.NESTEROV = nesterov
    cfg.TRAIN.LR_STEP = [2, 4]
    return cfg


@pytest.mark.parametrize("name,nesterov", [("adam", False), ("sgd", False),
                                           ("sgd", True)])
def test_optimizer_five_steps_match_optax(name, nesterov):
    """Adam, and SGD with weight decay, momentum and Nesterov: five steps
    on the same gradients, with the epoch's learning rate written in
    between, within 1e-6."""
    rng = np.random.RandomState(0)
    p0 = {"a": rng.randn(4, 3).astype(np.float32),
          "b": rng.randn(5).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(5)]
    jcfg = _opt_cfg(jax_default_config, name, nesterov)
    tx = jax_optim.get_optimizer(jcfg)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = tx.init(jp)
    cfg = _opt_cfg(get_default_config, name, nesterov)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    opt = optim.get_optimizer(cfg, tp.values())
    for epoch, g in enumerate(grads):
        jstate, jlr = jax_optim.epoch_lr_update(jstate, jcfg, epoch)
        lr = optim.epoch_lr_update(opt, cfg, epoch)
        assert lr == pytest.approx(jlr) and opt.param_groups[0]["lr"] == lr
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for k, v in g.items():
            tp[k].grad = torch.from_numpy(v.copy())
        opt.step()
    assert lr == pytest.approx(0.01 * 0.1 * 0.1)
    for k in p0:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("epoch,want", [(0, 1.0), (89, 1.0), (90, 0.1),
                                        (119, 0.1), (120, 0.01)])
def test_multistep_lr(epoch, want):
    assert optim.multistep_lr(1.0, [120, 90], 0.1, epoch) == \
        pytest.approx(want)


# ---------------------------------------------------------------------------
# bf16: f32 master weights
# ---------------------------------------------------------------------------

def test_bf16_step_keeps_parameters_and_adam_state_f32():
    cfg = _cfg(get_default_config, "resnet")
    cfg.TRAIN.OPTIMIZER = "adam"
    cfg.TRAIN.DTYPE = "bfloat16"
    g = UnetGenerator(input_nc=9, num_downs=6, ngf=NGF)
    state = create_advmix_state(cfg, get_pose_net(cfg), g,
                                torch.device("cpu"), torch.bfloat16)
    before = [p.detach().clone() for p in state.model_d.parameters()]
    step = make_advmix_step(state, cfg, alpha=ALPHA, adv_loss_weight=ADV_W)
    batch = _to_torch(_batches(np.random.RandomState(1), 64, 16,
                               np.float32, n=1)[0])
    batch["views"] = batch["views"].to(torch.bfloat16)
    metrics = step(batch)
    assert step.last_mix_weights.dtype == torch.float32
    assert all(torch.isfinite(v).all() for v in metrics.values())
    for model, opt in ((state.model_d, state.optimizer_d),
                       (state.model_g, state.optimizer_g)):
        assert all(p.dtype == torch.float32 for p in model.parameters())
        assert all(p.grad is None or p.grad.dtype == torch.float32
                   for p in model.parameters())
        assert opt.state and all(
            v.dtype == torch.float32 for s in opt.state.values()
            for k, v in s.items() if torch.is_tensor(v) and k != "step")
    assert any(not torch.equal(a, b) for a, b in
               zip(before, state.model_d.parameters()))
    # the teacher is frozen and its convolutions hold bf16 parameters
    assert not any(p.requires_grad for p in state.teacher.parameters())
    assert not state.teacher.training
    assert state.teacher.conv1.weight.dtype == torch.bfloat16


def test_set_compute_dtype_never_leaves_trainable_bf16_parameters():
    """The frozen form casts the convolutions and stops every gradient; the
    trainable form leaves all parameters f32; and the optimizer refuses
    bf16 parameters that still ask for a gradient."""
    cfg = _cfg(get_default_config, "resnet")
    frozen = set_compute_dtype(get_pose_net(cfg), torch.bfloat16)
    assert frozen.conv1.weight.dtype == torch.bfloat16
    assert frozen.bn1.weight.dtype == torch.float32
    assert not any(p.requires_grad for p in frozen.parameters())
    assert not [p for p in frozen.parameters() if p.requires_grad]
    trainable = set_compute_dtype(get_pose_net(cfg), torch.bfloat16,
                                  trainable=True)
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in trainable.parameters())
    x = torch.randn(1, 3, 64, 64)
    with torch.no_grad():
        assert frozen.eval()(x).dtype == torch.float32
        got, want = trainable.eval()(x), frozen(x)
    # the same bf16 arithmetic either way: the frozen model is the
    # trainable one with its casts done ahead of time
    assert torch.equal(got, want)
    bad = get_pose_net(cfg)
    bad.conv1.to(torch.bfloat16)
    with pytest.raises(TypeError, match="master weights"):
        optim.get_optimizer(cfg, bad.parameters())
