"""What the ranks of the port's multi-rank tests run
(tests/test_torch_dist_*.py). `parallel.dist.launch` spawns the ranks, which
import this module by its name: it imports the port and nothing of JAX, and
everything it gets comes as pickled arguments (configs, numpy weights and
batches), so the JAX side of a comparison stays in the test process."""

from __future__ import annotations

import contextlib
import os
import sys

import numpy as np
import torch

from advmix_tpu_torch.engine.state import AdvMixState, PoseState, \
    make_teacher
from advmix_tpu_torch.engine import steps
from advmix_tpu_torch.models import get_pose_net
from advmix_tpu_torch.models.convert import jax_to_torch_state_dict, \
    jax_unet_to_torch_state_dict, torch_to_jax_leaves
from advmix_tpu_torch.models.unet import UnetGenerator
from advmix_tpu_torch.parallel import dist as pdist

ADVMIX_KINDS = ("advmix", "bottomup_advmix")


@contextlib.contextmanager
def rank_sys_path():
    """sys.path without the JAX package's `tools/` and `scripts/` folders,
    which some test files put on it for good (tests/test_misc_paths.py,
    tests/test_corruptions.py): a spawned rank inherits sys.path, and
    there `tools/profile.py` would shadow the standard library's `profile`
    (torch imports cProfile on an optimizer's first use)."""
    kept = list(sys.path)
    sys.path[:] = [p for p in kept if os.path.basename(
        os.path.normpath(p)) not in ("tools", "scripts")]
    try:
        yield
    finally:
        sys.path[:] = kept


@contextlib.contextmanager
def stdlib_profile():
    """`rank_sys_path` for the test process itself, which also drops a
    `profile` module that came from elsewhere than the standard library
    out of sys.modules. torch imports cProfile, and with it `profile`,
    when it first imports `torch._dynamo`: at the first call of a custom op
    (the port's decode and int8 ops), an export or an optimizer step. A
    test that makes that first call after a JAX-package test left `tools/`
    on sys.path fails in the import (`module 'profile' has no attribute
    'run'`) unless cProfile was imported inside this before:
    tests/torch_port_util.py does so while the test files are collected."""
    shadow = sys.modules.get("profile")
    if shadow is not None and os.path.dirname(
            getattr(shadow, "__file__", "") or "") != os.path.dirname(
            os.__file__):
        del sys.modules["profile"]
    with rank_sys_path():
        yield


def port_d(cfg, flat: dict, dtype, device="cpu"):
    model = get_pose_net(cfg)
    model.load_state_dict(jax_to_torch_state_dict(flat, model))
    return model.to(device=device, dtype=dtype)


def port_g(flat: dict, num_downs: int, ngf: int, dtype, device="cpu"):
    model = UnetGenerator(input_nc=9, num_downs=num_downs, ngf=ngf)
    model.load_state_dict(jax_unet_to_torch_state_dict(flat, model))
    return model.to(device=device, dtype=dtype)


def run_case(case: dict, group, rows: slice, device="cpu") -> dict:
    """Build the case's state from its numpy weights, take its steps on
    `rows` of each global batch, and return D's (and G's) leaves in the JAX
    layout with the per-step metrics."""
    dtype = getattr(torch, case["dtype"])
    cfg, kind = case["cfg"], case["kind"]
    d = port_d(cfg, case["flat_d"], dtype, device)
    g = None
    if kind in ADVMIX_KINDS:
        g = port_g(case["flat_g"], case["num_downs"], case["ngf"], dtype,
                   device)
        teacher = make_teacher(port_d(cfg, case["flat_t"], dtype, device),
                               dtype)
        state = AdvMixState(
            d, torch.optim.SGD(d.parameters(), lr=case["lr_d"]), g,
            torch.optim.SGD(g.parameters(), lr=case["lr_g"]), teacher)
        kw = dict(alpha=case["alpha"], adv_loss_weight=case["adv_w"],
                  group=group)
        step = (steps.make_advmix_step(state, cfg,
                                       _mutation=case.get("mutation"), **kw)
                if kind == "advmix" else
                steps.make_bottomup_advmix_step(state, cfg, **kw))
    else:
        state = PoseState(d, torch.optim.SGD(d.parameters(),
                                             lr=case["lr_d"]))
        step = (steps.make_train_step(state, cfg, group=group)
                if kind == "train" else
                steps.make_bottomup_step(state, cfg, group=group))
    metrics = []
    for b in case["batches"]:
        batch = {k: torch.from_numpy(np.ascontiguousarray(v[rows])).to(
            device=device, dtype=dtype) for k, v in b.items()}
        metrics.append({k: float(v) for k, v in step(batch).items()})
    out = {"d": torch_to_jax_leaves(d), "metrics": metrics,
           "tracked": sorted({int(v) for k, v in d.state_dict().items()
                              if k.endswith("num_batches_tracked")})}
    if g is not None:
        out["g"] = torch_to_jax_leaves(g)
    return out


def _my_rows(n: int) -> slice:
    b = n // pdist.world()
    return slice(pdist.rank() * b, (pdist.rank() + 1) * b)


def _same_on_every_rank(result: dict) -> bool:
    """Rank 0's weights equal every rank's, bit for bit."""
    parts = pdist.gather_to_main({k: result[k] for k in ("d", "g")
                                  if k in result})
    if parts is None:
        return True
    return all(np.array_equal(p[net][k], parts[0][net][k])
               for p in parts for net in p for k in p[net])


def step_cases(cases: dict) -> dict:
    """Every case of `cases` on this rank's rows of its batches. Run by each
    rank of `launch`; rank 0's return value comes back."""
    dev = pdist.device()
    out = {}
    for name, case in cases.items():
        n = len(next(iter(case["batches"][0].values())))
        res = run_case(case, pdist.data_group(), _my_rows(n), dev)
        res["ranks_equal"] = _same_on_every_rank(res)
        out[name] = res
    return out


def random_corruption_draws(seed: int):
    """Each rank's `--random_corruption` branches and corrupted batch from
    the training run's generator (`trainer.rank_generator`), gathered on
    rank 0 in rank order."""
    from advmix_tpu_torch.engine.trainer import make_random_corruption_fn, \
        rank_generator

    fn = make_random_corruption_fn()
    img = torch.from_numpy(np.random.RandomState(41).uniform(
        0, 255, (4, 32, 24, 3)).astype(np.float32))
    gen = rank_generator(seed)
    # the draws `fn` makes first, read from a copy of the generator
    peek = torch.Generator()
    peek.set_state(gen.get_state())
    branches = torch.randint(0, fn.n_branches, (4,), generator=peek).tolist()
    out = fn(img, gen)
    return pdist.gather_to_main((branches, out.numpy()))


def collectives(group=None) -> dict:
    """The parallel layer's collectives on rank-dependent values, gathered
    on rank 0: a mean over two dtypes, BN statistics, a broadcast module,
    the cross-replica mean's gradient. `group`: a group or a mesh (default
    the data group)."""
    r = pdist.rank()
    group = pdist.data_group() if group is None else group
    a = torch.full((3,), float(r + 1))
    b = torch.arange(4, dtype=torch.float64) * (r + 1)
    pdist.all_reduce_mean_([a, b], group)
    bn = torch.nn.BatchNorm2d(2)
    bn.running_mean.fill_(r)
    bn.running_var.fill_(2.0 * r)
    bn.num_batches_tracked.fill_(r + 5)
    pdist.average_buffers_(bn, group)
    lin = torch.nn.Linear(2, 2)
    with torch.no_grad():
        lin.weight.fill_(r + 3)
    pdist.broadcast_module_(lin)
    x = torch.full((2,), float(r + 1), requires_grad=True)
    (pdist.AllReduceMean.apply(x, group) * (r + 1)).sum().backward()
    return pdist.gather_to_main(dict(
        a=a.tolist(), b=b.tolist(), mean=bn.running_mean.tolist(),
        var=bn.running_var.tolist(), tracked=int(bn.num_batches_tracked),
        weight=lin.weight.detach().flatten().tolist(), grad=x.grad.tolist(),
        fold=pdist.fold_rank(1234)))


def fail_on_rank(bad: int) -> None:
    """Rank `bad` raises; the others wait for it at a barrier."""
    if pdist.rank() == bad:
        raise ValueError(f"planted failure on rank {bad}")
    pdist.barrier()


# ---------------------------------------------------------------------------
# meshes: a ("dcn", "data") mesh for the steps, a ("data", "model") mesh for
# the spatial forward (tests/test_torch_mesh.py, tests/test_torch_spatial.py)
# ---------------------------------------------------------------------------

def _mesh_layout(mesh) -> dict:
    """Each axis's group as global ranks, as this rank sees it."""
    import torch.distributed as dist

    return {axis: dist.get_process_group_ranks(mesh.get_group(axis))
            for axis in mesh.mesh_dim_names}


def mesh_step_cases(cases: dict, num_slices: int) -> dict:
    """Every case of `cases` on this rank's rows of its batches, once over
    the flat group and once over a ("dcn", "data") mesh of `num_slices`
    slices, with the mesh's layout and the collectives' results on it."""
    dev = pdist.device()
    mesh = pdist.get_mesh(num_slices=num_slices)
    out = {"layout": pdist.gather_to_main(_mesh_layout(mesh)),
           "collectives": {"flat": collectives(),
                           "mesh": collectives(mesh)}}
    for name, case in cases.items():
        n = len(next(iter(case["batches"][0].values())))
        out[name] = {
            "flat": run_case(case, pdist.data_group(), _my_rows(n), dev),
            "mesh": run_case(case, mesh, _my_rows(n), dev)}
        out[name]["mesh"]["ranks_equal"] = _same_on_every_rank(
            out[name]["mesh"])
    return out


def _drop_one_halo_row(spatial):
    """A planted fault: the first time this rank fetches rows above its
    own block, the first of them comes back as zeros."""
    fetch = spatial._RowShards.fetch
    done = []

    def faulty(self, x, height, needs):
        rows = fetch(self, x, height, needs)
        lo = spatial.row_split(height, self.k, self.j)[0]
        if not done and needs[self.j][0] < lo and rows.shape[2]:
            rows = rows.clone()
            rows[:, :, 0] = 0
            done.append(True)
        return rows

    spatial._RowShards.fetch = faulty
    return fetch


def spatial_forwards(case: dict) -> dict:
    """The case's model on this rank's block of its batch through the
    spatial forward on a ("data", "model") mesh of `model_parallel`, in
    f32 and float64, beside the unsharded forward of the whole batch (this
    rank's data rows of it); gathered on rank 0 in rank order. With
    `mutation`, each spatial forward leaves out one halo row."""
    from advmix_tpu_torch.parallel import spatial

    mesh = pdist.get_mesh(model_parallel=case["model_parallel"])
    out = {"layout": _mesh_layout(mesh),
           "data_index": mesh.get_local_rank("data")}
    rows = spatial.shard_slices(case["x"].shape, (
        mesh.get_local_rank("data"), mesh.size(0)), (0, 1))[0]
    for dtype in ("float32", "float64"):
        model = port_d(case["cfg"], case["flat"],
                       getattr(torch, dtype)).eval()
        x = torch.from_numpy(case["x"]).to(getattr(torch, dtype))
        xs = spatial.spatial_shard(x, mesh)
        fn = spatial.make_spatial_forward(model, mesh)
        planted = (_drop_one_halo_row(spatial) if case.get("mutation")
                   else None)
        try:
            got = fn(xs)
        finally:
            if planted is not None:
                spatial._RowShards.fetch = planted
        with torch.no_grad():
            want = model(x)
        got = [got] if isinstance(got, torch.Tensor) else got
        want = [want] if isinstance(want, torch.Tensor) else want
        out[dtype] = {"got": [g.numpy() for g in got],
                      "want": [w[rows].numpy() for w in want]}
        out["shard"] = tuple(xs.shape)
        out["exchanges"] = fn.stats["exchanges"]
    return pdist.gather_to_main(out)


class _AvgPoolNet(torch.nn.Module):
    """A convolution, then an op the spatial forward does not know."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 4, 3, padding=1)

    def forward(self, x):
        return torch.nn.functional.avg_pool2d(self.conv(x), 2)


def spatial_refusals() -> dict:
    """What the spatial forward raises on a model with an op outside its
    allowlist, and for a model in training mode, on every rank."""
    from advmix_tpu_torch.parallel import spatial

    mesh = pdist.get_mesh(model_parallel=pdist.world())
    x = spatial.spatial_shard(torch.randn(2, 3, 16, 16), mesh)
    msgs = {}
    try:
        spatial.make_spatial_forward(_AvgPoolNet().eval(), mesh)(x)
    except NotImplementedError as e:
        msgs["avg_pool2d"] = str(e)
    try:
        net = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3, padding=1),
                                  torch.nn.BatchNorm2d(4)).train()
        spatial.make_spatial_forward(net, mesh)(x)
    except NotImplementedError as e:
        msgs["train_bn"] = str(e)
    return pdist.gather_to_main(msgs)


def spatial_cases(cases: dict) -> dict:
    """`spatial_forwards` of every case, by name."""
    return {name: spatial_forwards(case) for name, case in cases.items()}


def spatial_case_and_refusals(case: dict) -> dict:
    return {"forward": spatial_forwards(case), "refusals": spatial_refusals()}
