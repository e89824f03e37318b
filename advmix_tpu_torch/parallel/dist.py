"""Data parallelism: one process (rank) per device.

Counterpart of `advmix_tpu/parallel/mesh.py`. The JAX package runs one
program over a 1-D "data" mesh of N devices: a batch is sharded on its
leading axis (`P("data")`, device i holding rows [i*b, (i+1)*b)), the
parameters are replicated, and the steps `pmean` gradients and BatchNorm
statistics over the axis. Here the mesh is a `torch.distributed` group of
N ranks, each on its own device (`cuda:<local rank>`, or the CPU), each
loading its contiguous `b` rows of every global batch
(`data/loader.Loader(num_shards=, shard_index=)`), and the steps make the
JAX step's collectives explicitly (`engine/steps.py`): no
DistributedDataParallel, whose reducer would fire D's all-reduce inside the
AdvMix G update's backward through D, and whose buffer broadcast would
overwrite BN statistics from rank 0 where the JAX package averages them.

A world of one rank creates no process group: every function here is then
a no-op, and the steps run their single-device code.

`get_mesh` names axes over the group, as `mesh.py:get_mesh` does over the
devices: a ("dcn", "data") mesh (`num_slices`) is still pure data
parallelism, and the collectives below take it in place of a group and
reduce within "data", then across "dcn"; a ("data", "model") mesh
(`model_parallel`) shards one image's rows over "model"
(`parallel/spatial.py`).

Backends: NCCL when each rank has a card of its own, gloo when ranks share
a device (the CPU, or one card). Host-side objects (prediction shards,
counts, the score) always go over a gloo group, as the JAX package's
`process_allgather` / `broadcast_one_to_all` move them through the host.
"""

from __future__ import annotations

import multiprocessing.connection
import os
import tempfile
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..utils.device import resolve_device
from ..utils.profiling import count, span

# the rank's device and its host-object group, set by init_process_group:
# process-wide, as torch.distributed's own default group is
_RANK = {"device": None, "host_group": None}


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main() -> bool:
    return rank() == 0


def device() -> torch.device:
    """This rank's device (only inside a process group)."""
    if _RANK["device"] is None:
        raise RuntimeError("no process group: the caller picks the device")
    return _RANK["device"]


def data_group():
    """The group the steps reduce over: None for a world of one rank."""
    return dist.group.WORLD if world() > 1 else None


def get_mesh(num_devices: int | None = None, axis_name: str = "data",
             num_slices: int | None = None,
             model_parallel: int | None = None) -> DeviceMesh:
    """Named axes over the process group's ranks (`mesh.py:21-50`): a 1-D
    (axis_name,) mesh by default; `num_slices` > 1 gives ("dcn", axis_name),
    slice s holding ranks [s*n/num_slices, (s+1)*n/num_slices); and
    `model_parallel` = k > 1 gives (axis_name, "model"), model group d holding
    ranks [d*k, (d+1)*k), so that rank r is in data group r % k: the
    layouts of the JAX reshape of the device list. The two options are
    mutually exclusive. A mesh covers the whole group (`num_devices` is
    None or the world size), which must exist."""
    n = world() if num_devices is None else int(num_devices)
    if model_parallel and model_parallel > 1:
        assert not (num_slices and num_slices > 1), \
            "num_slices and model_parallel are mutually exclusive"
        assert n % model_parallel == 0, (n, model_parallel)
        shape, names = (n // model_parallel, model_parallel), (axis_name,
                                                               "model")
    elif num_slices and num_slices > 1:
        assert n % num_slices == 0, (n, num_slices)
        shape, names = (num_slices, n // num_slices), ("dcn", axis_name)
    else:
        shape, names = (n,), (axis_name,)
    if not dist.is_initialized() or n != world():
        raise RuntimeError(f"a mesh of {n} ranks needs a process group of "
                           f"{n} ranks (this process is in one of "
                           f"{world()}): start them with `launch`")
    return init_device_mesh(device().type, shape, mesh_dim_names=names)


def data_axes(mesh: DeviceMesh, axis_name: str = "data") -> tuple:
    """The axes a batch shards over and gradients reduce over
    (`mesh.py:53-59`): ("dcn", axis_name) on a multi-slice mesh, else
    (axis_name,)."""
    if "dcn" in mesh.mesh_dim_names:
        return ("dcn", axis_name)
    return (axis_name,)


def group_size(group) -> int:
    """The ranks a reduction over `group` (a group or a mesh) spans."""
    if isinstance(group, DeviceMesh):
        n = 1
        for axis in data_axes(group):
            n *= group.size(group.mesh_dim_names.index(axis))
        return n
    return dist.get_world_size(group)


def all_reduce_(t: torch.Tensor, group) -> None:
    """Sum `t` in place over `group`. A mesh reduces hierarchically, over
    its data axes from the innermost: within "data", then across "dcn", as
    XLA schedules a `pmean` over `data_axes` (intra-slice, then the
    cross-slice hop). One `advmix.all_reduce` span and count event a call
    in a profiled run."""
    count("all_reduce")
    with span("advmix.all_reduce"):
        if isinstance(group, DeviceMesh):
            for axis in reversed(data_axes(group)):
                dist.all_reduce(t, group=group.get_group(axis))
        else:
            dist.all_reduce(t, group=group)


def backend_for(devices) -> str:
    """NCCL when every rank has a card of its own, else gloo (ranks on the
    CPU, or several on one card: NCCL refuses two ranks on a device)."""
    devs = [torch.device(d) for d in devices]
    own_cards = (all(d.type == "cuda" for d in devs)
                 and len({d.index for d in devs}) == len(devs))
    return "nccl" if own_cards else "gloo"


def torchrun_env() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_process_group(rank_: int | None = None, world_: int | None = None,
                       devices=None, init_file: str | None = None) -> None:
    """Join the group: from torchrun's RANK / WORLD_SIZE / LOCAL_RANK when
    `rank_` is None (the device is `cuda:<LOCAL_RANK>`; `devices` is the
    `--device` string, and the ranks run on the CPU only where it says so:
    without a card this raises), else as rank `rank_` of `world_`, on
    `devices[rank_]`, meeting the others at `init_file`."""
    if rank_ is None:
        rank_, world_ = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local = int(os.environ.get("LOCAL_RANK", rank_))
        dev = resolve_device(devices)
        if dev.type == "cuda":
            dev = torch.device("cuda", local)
        backend, init = ("nccl" if dev.type == "cuda" else "gloo"), "env://"
    else:
        dev = torch.device(devices[rank_])
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", 0)
        backend, init = backend_for(devices), "file://" + init_file
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init, rank=rank_,
                            world_size=world_)
    _RANK["device"] = dev
    _RANK["host_group"] = (None if backend == "gloo"
                           else dist.new_group(backend="gloo"))


def destroy_process_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
    _RANK.update(device=None, host_group=None)


# ---------------------------------------------------------------------------
# collectives on tensors (the steps' pmean / psum)
# ---------------------------------------------------------------------------

def _coalesced(tensors, op, group, scale: float | None) -> None:
    """One collective per (dtype, device) over the flattened tensors,
    written back in place; the result is divided by `scale` where it is
    given (the world size after a sum: pmean)."""
    by_kind: dict = {}
    for t in tensors:
        by_kind.setdefault((t.dtype, t.device), []).append(t)
    for ts in by_kind.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        op(flat, group)
        if scale is not None:
            flat.div_(scale)
        for t, v in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(v.view_as(t))


def all_reduce_mean_(tensors, group) -> None:
    """`lax.pmean` in place: each tensor becomes the mean over the ranks
    (a sum, then a division by the world size, as `pmean` computes it).
    Tensors of one dtype go as one flat buffer: W32 D's ~1,000 gradients
    make one call. `group` is a group or a mesh (`all_reduce_`); the
    division is by every rank it spans."""
    ts = list(tensors)
    if ts:
        _coalesced(ts, all_reduce_, group, float(group_size(group)))


def all_reduce_sum_(tensors, group) -> None:
    """`lax.psum` in place."""
    ts = list(tensors)
    if ts:
        _coalesced(ts, all_reduce_, group, None)


def grads_of(module) -> list:
    """The parameters' gradients, in parameter order (None skipped: the
    same on every rank, since every rank runs the same graph)."""
    return [p.grad for p in module.parameters() if p.grad is not None]


def bn_buffers(module) -> list:
    """BatchNorm running_mean / running_var (not num_batches_tracked, a
    count that is the same on every rank)."""
    return [b for m in module.modules()
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
            and m.track_running_stats
            for b in (m.running_mean, m.running_var)]


def average_buffers_(module, group) -> None:
    """The JAX steps' `pmean` of the new batch_stats."""
    all_reduce_mean_(bn_buffers(module), group)


def broadcast_module_(module, src: int = 0, group=None) -> None:
    """Every parameter and buffer from rank `src`, as `replicate` puts one
    copy of the state on every device (after init and after a resume)."""
    if world() == 1:
        return
    ts = [t.data for t in list(module.parameters()) + list(module.buffers())]
    with span("advmix.broadcast"):
        _coalesced(ts, lambda f, g: dist.broadcast(f, src, group=g), group,
                   None)


class AllReduceMean(torch.autograd.Function):
    """The mean over the ranks with its transpose: forward and backward
    each sum over the group and divide by its size (JAX's `pmean` and its
    transpose under `shard_map`). Cross-replica BatchNorm averages its
    E[x] and E[x^2] through it. `group` is a group or a mesh."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        all_reduce_(y, group)
        return y / group_size(group)

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        all_reduce_(g, ctx.group)
        return g / group_size(ctx.group), None


# ---------------------------------------------------------------------------
# host objects (the JAX package's process_allgather / broadcast_one_to_all)
# ---------------------------------------------------------------------------

def gather_to_main(obj) -> list | None:
    """Every rank's `obj`, in rank order, on rank 0 (None elsewhere)."""
    out = [None] * world() if is_main() else None
    dist.gather_object(obj, out, dst=0, group=_RANK["host_group"])
    return out


def broadcast_from_main(obj):
    """Rank 0's `obj` on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=_RANK["host_group"])
    return box[0]


def barrier() -> None:
    if world() > 1:
        dist.barrier(group=_RANK["host_group"])


def fold_rank(seed: int) -> int:
    """A seed of this rank's own, as the JAX package folds the replica
    index into a key (`jax.random.fold_in(key, axis_index)`); rank 0, and a
    world of one, keep `seed`."""
    r = rank()
    return seed if r == 0 else (seed * 1000003 + r * 7919) % (2 ** 63)


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------

def _rank_main(rank_: int, devices, tmp: str, fn, args) -> None:
    if torch.device(devices[rank_]).type == "cpu":
        torch.set_num_threads(1)  # N ranks share the host's cores
    try:
        if len(devices) > 1:
            init_process_group(rank_, len(devices), devices,
                               os.path.join(tmp, "init"))
        result = fn(*args)
        if rank_ == 0:
            path = os.path.join(tmp, "result.pt")
            torch.save(result, path + ".tmp")
            os.replace(path + ".tmp", path)
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank_}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        destroy_process_group()


def launch(fn, devices, *args):
    """Run `fn(*args)` once per entry of `devices`, each in a process of
    its own (start method spawn) as the rank of that index, in one process
    group. Returns rank 0's result, moved to the CPU (it comes back through
    `torch.save`). If any rank fails, the others are stopped and this
    raises with the tracebacks of the ranks that raised; no failure is
    swallowed.
    `fn` and `args` must pickle: `fn` by its import path."""
    devices = [str(d) for d in devices]
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="advmix_ranks_") as tmp:
        procs = [ctx.Process(target=_rank_main, args=(r, devices, tmp, fn,
                                                      args))
                 for r in range(len(devices))]
        try:
            for p in procs:
                p.start()
            failed = _wait(procs)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join()
        if failed is not None:
            # the first rank seen to fail, and every rank that raised (a
            # rank waiting on a failed one may raise in its collective)
            errs = {failed[0]: ""}
            for r in range(len(devices)):
                err = os.path.join(tmp, f"rank{r}.err")
                if os.path.isfile(err):
                    with open(err) as f:
                        errs[r] = f.read()
            raise RuntimeError(
                f"rank(s) {sorted(errs)} of {len(devices)} failed (first "
                f"seen: rank {failed[0]}, exit code {failed[1]})\n"
                + "\n".join(f"--- rank {r}:\n{why}"
                            for r, why in sorted(errs.items())))
        return torch.load(os.path.join(tmp, "result.pt"), map_location="cpu",
                          weights_only=False)


def _wait(procs):
    """Wait until every rank exits; returns (rank, exit code) of the first
    to fail, else None. A rank left waiting in a collective for one that
    failed never exits by itself: the caller stops it."""
    while True:
        for r, p in enumerate(procs):
            if p.exitcode not in (None, 0):
                return r, p.exitcode
        alive = [p for p in procs if p.exitcode is None]
        if not alive:
            return None
        multiprocessing.connection.wait([p.sentinel for p in alive])
