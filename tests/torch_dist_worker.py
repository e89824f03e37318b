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
    which some test files put on it for good: a spawned rank inherits
    sys.path, and there `tools/profile.py` would shadow the standard
    library's `profile` (torch imports cProfile on an optimizer's first
    use)."""
    kept = list(sys.path)
    sys.path[:] = [p for p in kept if os.path.basename(
        os.path.normpath(p)) not in ("tools", "scripts")]
    try:
        yield
    finally:
        sys.path[:] = kept


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


def collectives() -> dict:
    """The parallel layer's collectives on rank-dependent values, gathered
    on rank 0: a mean over two dtypes, BN statistics, a broadcast module,
    the cross-replica mean's gradient."""
    r, group = pdist.rank(), pdist.data_group()
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
