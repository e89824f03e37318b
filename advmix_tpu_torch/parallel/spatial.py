"""Spatial partitioning: one image's rows over the ranks of a "model" group.

Counterpart of `advmix_tpu/parallel/spatial.py`. There a plain `jax.jit` of
`model.apply` gets images sharded `P("data", "model")` (batch over "data",
height over "model"), parameters replicated, and XLA's partitioner inserts
each convolution's halo exchange; the outputs are fetched whole. It is an
eval-mode feature for large scenes (the bottom-up family). Here the model
code is untouched too: `make_spatial_forward` runs it under a
`TorchFunctionMode` that holds every activation as "this rank's rows of a
tensor of height H", always in GSPMD's ceil-split of its own height (shard
j of k holds rows [j*c, min((j+1)*c, H)), c = ceil(H / k), so the last
shards of a short height are empty).

The mode rewrites the four ops that mix rows in the top-down and bottom-up
models: `F.conv2d`, `F.conv_transpose2d`, `F.max_pool2d` and nearest
`F.interpolate` by an integer power of two. For each, the input rows that
this rank's output block needs follow from kernel, stride and padding; the
rows other ranks hold are fetched; the op runs with no height padding on
those rows, with the true image edges padded by what the op pads with (zeros
for a convolution, -inf for the pool); the result is the output's ceil-split
block. The ops that act per row or per channel pass through: eval-mode
BatchNorm, ReLU, add, `torch.cat` over channels, dtype casts. Any other op
on a row-sharded tensor raises with the op's name: nothing computes on
partial rows unnoticed.

Every exchange is one `all_reduce` (a sum) over the model group of a
zero-filled buffer with a slot per rank, each rank writing the rows it
sends into its own slot: NCCL runs it on the card, and gloo, where ranks
share a card, takes CUDA tensors for `all_reduce` (staging them through
host memory) but not for point-to-point or `all_gather`. Adding zeros is
exact, so the fetched rows are the sender's bits. Every rank of a model
group makes the same exchanges in the same order, an empty shard too: the
rows each rank needs follow from the heights alone, which all know.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.overrides import TorchFunctionMode
from torch.utils.weak import WeakIdKeyDictionary


def row_split(height: int, k: int, j: int) -> tuple:
    """Rows [lo, hi) of shard `j` of `k` over `height` rows: GSPMD's split,
    ceil(height / k) rows per shard, the last ones short or empty."""
    c = -(-height // k)
    return min(j * c, height), min((j + 1) * c, height)


def shard_slices(shape, data: tuple, model: tuple) -> tuple:
    """The (batch, row) slices of an NCHW `shape` that the rank at
    (data index, data size) = `data` and (model index, model size) =
    `model` holds: even batch blocks over "data" (the batch must divide),
    ceil-split rows over "model"."""
    (di, dn), (mi, mn) = data, model
    b = shape[0]
    if b % dn:
        raise ValueError(f"batch {b} does not divide over {dn} data ranks")
    lo, hi = row_split(shape[2], mn, mi)
    return slice(di * b // dn, (di + 1) * b // dn), slice(lo, hi)


def _axis(mesh: DeviceMesh, name: str) -> tuple:
    """(this rank's index, size) along the mesh's axis `name`."""
    return (mesh.get_local_rank(name),
            mesh.size(mesh.mesh_dim_names.index(name)))


def spatial_shard(images: torch.Tensor, mesh: DeviceMesh,
                  data_axis: str = "data",
                  spatial_axis: str = "model") -> torch.Tensor:
    """This rank's block of an NCHW batch (the counterpart of
    `spatial_sharding` and a `device_put`): its batch rows over
    `data_axis`, its image rows over `spatial_axis`."""
    bs, rs = shard_slices(images.shape, _axis(mesh, data_axis),
                          _axis(mesh, spatial_axis))
    return images[bs, :, rs]


def _pair(v) -> tuple:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


class _RowShards(TorchFunctionMode):
    """Runs a model on row blocks of its activations over `group`, this
    rank being shard `j` of `k`. `heights` maps each row-sharded tensor to
    the height of the tensor it is a block of. `stats` counts the
    exchanges, their bytes and their buffers' shapes."""

    def __init__(self, group, k: int, j: int, stats: dict):
        super().__init__()
        self.group, self.k, self.j, self.stats = group, k, j, stats
        self.heights = WeakIdKeyDictionary()
        self.rows_ops = {
            torch.conv2d: self._conv2d,
            torch.conv_transpose2d: self._conv_transpose2d,
            F.max_pool2d: self._max_pool2d,
            torch.max_pool2d: self._max_pool2d,
            F.interpolate: self._interpolate,
        }

    # ---- bookkeeping ----------------------------------------------------

    def tag(self, t: torch.Tensor, height: int) -> torch.Tensor:
        self.heights[t] = height
        return t

    def _height_of(self, func, args, kwargs):
        """(the one height of the row-sharded tensors among the arguments,
        or None where there are none; the other tensors)."""
        found, loose = set(), []

        def visit(a):
            if isinstance(a, torch.Tensor):
                if a in self.heights:
                    found.add(self.heights[a])
                else:
                    loose.append(a)
            elif isinstance(a, (list, tuple)):
                for b in a:
                    visit(b)

        for a in list(args) + list(kwargs.values()):
            visit(a)
        if len(found) > 1:
            raise NotImplementedError(
                f"spatial forward: {_name(func)} mixes tensors of heights "
                f"{sorted(found)}")
        return (found.pop() if found else None), loose

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        height, loose = self._height_of(func, args, kwargs)
        if height is None:
            return func(*args, **kwargs)
        if func in self.rows_ops:
            return self.rows_ops[func](height, *args, **kwargs)
        # a per-row op may broadcast a (C, 1, 1) tensor, not a whole map
        if not _per_row(func, args, kwargs) or any(
                t.dim() == 4 and t.shape[2] > 1 for t in loose):
            raise NotImplementedError(
                f"spatial forward: {_name(func)} on a row-sharded tensor is "
                "not supported (it would compute on this rank's rows alone)")
        out = func(*args, **kwargs)
        if isinstance(out, torch.Tensor) and out.dim() == 4:
            self.tag(out, height)
        return out

    # ---- the exchange -----------------------------------------------------

    def fetch(self, x: torch.Tensor, height: int, needs: list):
        """Rows needs[self.j] = [a, b) (within [0, height)) of the tensor
        whose block `x` is; needs[i] is what rank i asks for, and every rank
        of the group calls this with the same `needs`. One all_reduce over
        the group when any rank needs rows another holds, else none."""
        k, me = self.k, self.j
        blocks = [row_split(height, k, i) for i in range(k)]
        # sends[i]: (dst, lo, hi) row ranges that rank i sends
        sends = [[(d, max(a, lo), min(b, hi))
                  for d, (a, b) in enumerate(needs)
                  if d != i and max(a, lo) < min(b, hi)]
                 for i, (lo, hi) in enumerate(blocks)]
        a, b = needs[me]
        lo = blocks[me][0]
        if not any(sends):
            return x[:, :, a - lo:b - lo]
        slot = max(sum(h - l for _, l, h in s) for s in sends)
        nb, c, _, w = x.shape
        buf = x.new_zeros((k, nb, c, slot, w))
        off = 0
        for _, l, h in sends[me]:
            buf[me, :, :, off:off + h - l] = x[:, :, l - lo:h - lo]
            off += h - l
        dist.all_reduce(buf, group=self.group)
        self.stats["exchanges"] += 1
        self.stats["bytes"] += buf.numel() * buf.element_size()
        self.stats["shapes"].append((tuple(buf.shape), buf.dtype))
        parts = []
        for i, (blo, bhi) in enumerate(blocks):  # shards in row order
            l, h = max(a, blo), min(b, bhi)
            if l >= h:
                continue
            if i == me:
                parts.append(x[:, :, l - lo:h - lo])
                continue
            off = 0
            for d, sl, sh in sends[i]:
                if d == me:
                    break
                off += sh - sl
            parts.append(buf[i, :, :, off:off + h - l])
        return torch.cat(parts, dim=2) if parts else x[:, :, :0]

    def window_op(self, height: int, x, out_h: int, first, span: int,
                  pad_value: float, run):
        """A windowed op whose output row o reads input rows
        [o*s - p, o*s - p + span): `first(o)` = o*s - p. Fetches the rows of
        this rank's output block, pads the image edges with `pad_value`,
        and returns `run(rows)` (the op with no height padding), tagged."""
        blocks = [row_split(out_h, self.k, i) for i in range(self.k)]
        needs = []
        for o0, o1 in blocks:
            if o0 == o1:
                needs.append((0, 0))
            else:
                needs.append((max(first(o0), 0),
                              min(first(o1 - 1) + span, height)))
        rows = self.fetch(x, height, needs)
        o0, o1 = blocks[self.j]
        if o0 == o1:
            return None
        top = max(0, -first(o0))
        bottom = max(0, first(o1 - 1) + span - height)
        if top or bottom:
            rows = F.pad(rows, (0, 0, top, bottom), value=pad_value)
        return self.tag(run(rows), out_h)

    def _empty(self, x, channels: int, out_h: int, out_w: int):
        return self.tag(x.new_zeros((x.shape[0], channels, 0, out_w)), out_h)

    # ---- the four row-mixing ops -------------------------------------------

    def _conv2d(self, height, input, weight, bias=None, stride=1, padding=0,
                dilation=1, groups=1):
        (s, sw), (d, dw) = _pair(stride), _pair(dilation)
        if isinstance(padding, str):
            raise NotImplementedError(f"spatial forward: conv2d padding "
                                      f"{padding!r}")
        p, pw = _pair(padding)
        k, kw = weight.shape[2:]
        span = d * (k - 1) + 1
        out_h = (height + 2 * p - span) // s + 1
        out_w = (input.shape[3] + 2 * pw - dw * (kw - 1) - 1) // sw + 1
        y = self.window_op(
            height, input, out_h, lambda o: o * s - p, span, 0.0,
            lambda r: F.conv2d(r, weight, bias, (s, sw), (0, pw), (d, dw),
                               groups))
        return (self._empty(input, weight.shape[0], out_h, out_w)
                if y is None else y)

    def _max_pool2d(self, height, input, kernel_size, stride=None, padding=0,
                    dilation=1, ceil_mode=False, return_indices=False):
        if ceil_mode or return_indices:
            raise NotImplementedError("spatial forward: max_pool2d with "
                                      "ceil_mode or return_indices")
        (k, kw), (d, dw) = _pair(kernel_size), _pair(dilation)
        s, sw = _pair(kernel_size if stride in (None, []) else stride)
        p, pw = _pair(padding)
        span = d * (k - 1) + 1
        out_h = (height + 2 * p - span) // s + 1
        out_w = (input.shape[3] + 2 * pw - dw * (kw - 1) - 1) // sw + 1
        y = self.window_op(
            height, input, out_h, lambda o: o * s - p, span, -math.inf,
            lambda r: F.max_pool2d(r, (k, kw), (s, sw), (0, pw), (d, dw)))
        return (self._empty(input, input.shape[1], out_h, out_w)
                if y is None else y)

    def _interpolate(self, height, input, size=None, scale_factor=None,
                     mode="nearest", align_corners=None,
                     recompute_scale_factor=None, antialias=False):
        f = scale_factor[0] if isinstance(scale_factor, (tuple, list)) \
            else scale_factor
        if (mode != "nearest" or size is not None or antialias
                or recompute_scale_factor or f is None
                or _pair(scale_factor)[0] != _pair(scale_factor)[1]
                or f < 1 or f != int(f) or int(f) & (int(f) - 1)):
            raise NotImplementedError(
                "spatial forward: interpolate other than nearest by an "
                f"integer power of two (mode {mode!r}, size {size}, "
                f"scale_factor {scale_factor})")
        f = int(f)
        # output row o copies input row o // f: a window of one row
        y = self.window_op(
            height, input, height * f, lambda o: o // f, 1, 0.0,
            lambda r: F.interpolate(r, scale_factor=f, mode="nearest"))
        if y is None:
            return self._empty(input, input.shape[1], height * f,
                               input.shape[3] * f)
        return y

    def _conv_transpose2d(self, height, input, weight, bias=None, stride=1,
                          padding=0, output_padding=0, groups=1, dilation=1):
        """Output row o sums input rows i with i*s - p <= o <
        i*s - p + span: the rows [ceil((o0 + p - span + 1) / s),
        (o1 - 1 + p) // s + 1) for the block [o0, o1)."""
        (s, sw), (p, pw) = _pair(stride), _pair(padding)
        (op, opw), (d, dw) = _pair(output_padding), _pair(dilation)
        k, kw = weight.shape[2:]
        span = d * (k - 1) + 1
        out_h = (height - 1) * s - 2 * p + span + op
        out_w = ((input.shape[3] - 1) * sw - 2 * pw + dw * (kw - 1) + opw
                 + 1)
        cout = weight.shape[1] * groups
        blocks = [row_split(out_h, self.k, i) for i in range(self.k)]
        needs = []
        for o0, o1 in blocks:
            i0 = max(0, -((span - 1 - o0 - p) // s))  # ceil((o0+p-span+1)/s)
            i1 = min(height, (o1 - 1 + p) // s + 1)
            needs.append((i0, i1) if o0 < o1 and i0 < i1 else (0, 0))
        rows = self.fetch(input, height, needs)
        o0, o1 = blocks[self.j]
        if o0 == o1:
            return self._empty(input, cout, out_h, out_w)
        out = input.new_zeros((input.shape[0], cout, o1 - o0, out_w))
        i0 = needs[self.j][0]
        if rows.shape[2]:
            y = F.conv_transpose2d(rows, weight, None, (s, sw), (0, pw),
                                   (0, opw), groups, (d, dw))
            g0 = i0 * s - p  # the output row of y's row 0
            lo, hi = max(o0, g0), min(o1, g0 + y.shape[2])
            if lo < hi:
                if lo == o0 and hi == o1:
                    out = y[:, :, o0 - g0:o1 - g0]
                else:
                    out[:, :, lo - o0:hi - o0] = y[:, :, lo - g0:hi - g0]
        if bias is not None:
            out = out + bias[:, None, None]
        return self.tag(out, out_h)


# ops that act on each row (and channel) on its own; the getters read
# metadata that sharding leaves alone (not `shape`, which is the block's)
_PER_ROW = {torch.relu, torch.relu_, F.relu, torch.Tensor.relu,
            torch.Tensor.relu_, torch.add, torch.Tensor.add,
            torch.Tensor.__add__, torch.Tensor.__radd__, torch.Tensor.add_,
            torch.Tensor.__iadd__, torch.Tensor.to, torch.Tensor.float,
            torch.Tensor.double, torch.Tensor.half, torch.Tensor.bfloat16,
            torch.Tensor.contiguous, torch.Tensor.dim, torch.cat,
            F.batch_norm, torch.batch_norm}
_GETTERS = {"dtype", "device", "is_cuda", "requires_grad", "ndim", "layout",
            "is_sparse", "is_quantized", "is_meta", "is_nested"}


def _name(func) -> str:
    if getattr(func, "__name__", "") == "__get__":
        return f"Tensor.{func.__self__.__name__}"
    return getattr(func, "__qualname__", None) or repr(func)


def _per_row(func, args, kwargs) -> bool:
    if getattr(func, "__name__", "") == "__get__":
        return func.__self__.__name__ in _GETTERS
    if func not in _PER_ROW:
        return False
    if func is torch.cat:
        dim = kwargs.get("dim", args[1] if len(args) > 1 else 0)
        return dim in (0, 1, -3, -4)
    if func in (F.batch_norm, torch.batch_norm):
        # training mode: statistics over every row of every shard
        training = kwargs.get("training", args[5] if len(args) > 5 else False)
        return not training
    return True


def make_spatial_forward(model, mesh: DeviceMesh, *, data_axis: str = "data",
                         spatial_axis: str = "model", train: bool = False):
    """`fn(images_local)`: `model` on this rank's block of an NCHW batch
    (`spatial_shard`), returning the full-height outputs of this rank's
    batch rows, gathered over `spatial_axis` (a tensor, or a list for
    HigherHRNet's two scales), as `jax.device_get` fetches the JAX
    function's. No gradient is taken. `fn.stats` counts the last call's
    exchanges ("exchanges", "bytes", the buffers' "shapes").

    Eval mode only: `train=True` raises, as the JAX function does for a
    BatchNorm model (its apply cannot update `batch_stats` there), since
    batch statistics would span every shard."""
    names = mesh.mesh_dim_names
    assert spatial_axis in names, (spatial_axis, names)
    assert data_axis in names, (data_axis, names)
    if train:
        raise NotImplementedError("the spatial forward is eval-mode: "
                                  "BatchNorm's batch statistics would span "
                                  "every shard")
    group = mesh.get_group(spatial_axis)
    j, k = _axis(mesh, spatial_axis)
    stats = {}

    @torch.no_grad()
    def fn(images_local: torch.Tensor):
        stats.update(exchanges=0, bytes=0, shapes=[])
        height = torch.tensor([images_local.shape[2]],
                              device=images_local.device)
        dist.all_reduce(height, group=group)
        mode = _RowShards(group, k, j, stats)
        with mode:
            out = model(mode.tag(images_local, int(height)))
        outs = [out] if isinstance(out, torch.Tensor) else list(out)
        full = [_gather_rows(o, mode, group) for o in outs]
        return full[0] if isinstance(out, torch.Tensor) else full

    fn.stats = stats
    return fn


def _gather_rows(x: torch.Tensor, mode: _RowShards, group) -> torch.Tensor:
    """The whole height of the tensor whose block `x` is, on every rank of
    the group: each rank fills its slot of a zero buffer, all_reduce."""
    if x not in mode.heights:
        raise NotImplementedError("spatial forward: the model returned a "
                                  "tensor that is not row-sharded")
    height, k, me = mode.heights[x], mode.k, mode.j
    blocks = [row_split(height, k, i) for i in range(k)]
    if k == 1:
        return x
    c = blocks[0][1] - blocks[0][0]
    nb, ch, _, w = x.shape
    buf = x.new_zeros((k, nb, ch, c, w))
    buf[me, :, :, :x.shape[2]] = x
    dist.all_reduce(buf, group=group)
    return torch.cat([buf[i, :, :, :hi - lo]
                      for i, (lo, hi) in enumerate(blocks)], dim=2)
