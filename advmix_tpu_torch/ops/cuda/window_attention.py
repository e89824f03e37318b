"""Windowed multi-head self-attention with a relative-position bias
(HRFormer's `LocalWindowSelfAttention` around Swin's `WindowMSA`).

The CUDA kernels are `advmix_tpu_torch/csrc/window_attn.cuh`, entered
through `csrc/window_attn.cu` and instantiated by `csrc/window_attn_*.cu`.
They replace no TPU kernel: the JAX package has no attention. They were
added for HRFormer-B (`models/pose_hrformer.py`), whose every transformer
block runs `softmax(q k^T * d^-0.5 + B[rel]) v` over 7x7 windows of 49
tokens at head dim 39 with an additive learned bias, a shape no fused
PyTorch path takes.
Left to plain torch ops the block is a chain of pads, permutes, a gathered
bias and a materialized f32 softmax (43 MB a block call on branch 1 at
batch 32). Bound: HBM bytes (about 24 FLOP a byte, far under the H100's
~295); `window_attn_bytes` counts the least traffic.

`window_attention(qkv, bias, table, heads, window)` takes the qkv
projection's output in token layout, (B, H, W, 3C) with q, k, v each
(heads, d) on the last axis (the published `reshape(B, N, 3, heads, d)`),
and gives (B, H, W, C), ready for the output projection. The map is
centre-padded to whole windows as the source pads it with zeros before the
projection, so a padded token's key and value are the projection's bias
`bias` (3C); a padded query's output is cropped away and not computed. The
partition, the padding and the crop are the kernels' own addressing.

It calls the custom ops `advmix_tpu_torch::window_attn` and
`advmix_tpu_torch::window_attn_backward` through a `torch.autograd.Function`:
their CUDA implementations launch the kernels (forward: one launch;
backward: the gradient kernel and the reduction of the bias table's and
the padded keys' gradients, two launches), their CPU implementations are
the plain versions in this module, and their fake implementations give the
shapes. For a CUDA tensor it launches or raises; it never falls back.
bf16 or f32 in, f32 softmax and sums, the input's dtype out.

Two routes (`kernel_route`, from the input's dtype; design in
`csrc/window_attn.cuh`). f32 takes the "simt" kernels: a thread a query
row, f32 FMAs, for f32 configurations and the card's 1e-5 tests. bf16
takes the "mma" kernels, on the tensor cores: a block covers a window for
one head and walks a fixed set of windows, on a grid of about as many
blocks as the card holds at once (`mma_blocks` of the kernel's residency,
which the C side reads from the device). A token's q, k, v of the head
are runs of neighbouring channels, copied as whole 16-byte chunks into
shared memory while the previous window computes, then into bf16 tiles as
aligned words (the columns shifted by the parity the runs start at); one
warp a 16-row tile runs `mma.sync` m16n8k16 with f32 sums; P and dS, which
are f32, enter the products as a pair of bf16 (hi = bf16(x), lo = bf16(x -
hi): ~16 bits of their mantissa). What bounds them is each window's chain
of copy, compute and write-back at the warps an SM holds, not the bytes.
`window_attention.launches` counts the launches and
`window_attention.routes` the same launches by the route of their call,
the backward's reduction included (so the two routes' counts add up to
`launches`); each call runs in an `advmix.window_attn` span with one
`advmix.count.window_attn` event a launch, and one
`advmix.count.window_attn_mma` a tensor-core kernel (the reduction is
none), while a profiler records. Everything stays on the device, so a
CUDA graph captures it.

Backward order of sums, both routes: a block adds its windows' score
gradients into the bias table's 169 entries and the padded keys' k and v
gradients into the bias, in a fixed order, and keeps its own partial
sums; a second kernel adds the blocks' partials in block order. No
atomics: the gradients are the same bits from run to run, and differ from
the plain version's by the order of f32 sums only (a relative ~1e-6 of the
table's gradient per thousand windows summed).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...utils.profiling import count, span
from .build import check_cuda_tensor, check_status, library

# the kernels' fixed window and largest head dim (csrc/window_attn.cuh)
KERNEL_WINDOW = 7
MAX_HEAD_DIM = 40
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def relative_position_index(window: int) -> torch.Tensor:
    """(N, N) int64, N = window^2: the bias-table row of query token i and
    key token j, Swin's (2w-1)(yi - yj + w - 1) + (xi - xj + w - 1)."""
    ys, xs = torch.meshgrid(torch.arange(window), torch.arange(window),
                            indexing="ij")
    y, x = ys.reshape(-1), xs.reshape(-1)
    dy = y[:, None] - y[None, :] + window - 1
    dx = x[:, None] - x[None, :] + window - 1
    return dy * (2 * window - 1) + dx


def centre_pad(h: int, w: int, window: int) -> tuple:
    """(top, bottom, left, right) zero rows and columns that make an (h, w)
    map whole windows, split as the source splits them (the smaller half
    first)."""
    ph, pw = -h % window, -w % window
    return ph // 2, ph - ph // 2, pw // 2, pw - pw // 2


def num_windows(h: int, w: int, window: int) -> tuple:
    t, b, le, r = centre_pad(h, w, window)
    return (h + t + b) // window, (w + le + r) // window


def _dims(qkv: torch.Tensor, heads: int) -> tuple:
    if qkv.dim() != 4 or qkv.shape[-1] % (3 * heads):
        raise ValueError(f"qkv must be (B, H, W, 3C) with C a multiple of "
                         f"{heads} heads, got {tuple(qkv.shape)}")
    c = qkv.shape[-1] // 3
    return c, c // heads


def _partition(x: torch.Tensor, window: int, parts: int, heads: int):
    """(B, Hp, Wp, parts * heads * d) -> (parts, B * windows, heads, N, d)
    f32, windows in row-major order, tokens row-major in a window."""
    b, hp, wp, ch = x.shape
    d = ch // (parts * heads)
    nh, nw = hp // window, wp // window
    return x.view(b, nh, window, nw, window, parts, heads, d).permute(
        5, 0, 1, 3, 6, 2, 4, 7).reshape(parts, b * nh * nw, heads,
                                        window * window, d).to(torch.float32)


def _merge(t: torch.Tensor, b: int, hp: int, wp: int, window: int):
    """The inverse of `_partition`: (parts, B * windows, heads, N, d) ->
    (B, Hp, Wp, parts * heads * d)."""
    parts, _, heads, _, d = t.shape
    nh, nw = hp // window, wp // window
    return t.view(parts, b, nh, nw, heads, window, window, d).permute(
        1, 2, 5, 3, 6, 0, 4, 7).reshape(b, hp, wp, parts * heads * d)


def _plain_scores(qkv, bias, table, heads: int, window: int):
    """The padded map's q, k, v windows and the softmax's probabilities
    and log-sums: (q, k, v, p, lse, pads)."""
    b, h, w, c3 = qkv.shape
    _, d = _dims(qkv, heads)
    pads = centre_pad(h, w, window)
    top, bottom, left, right = pads
    full = bias.to(qkv.dtype).expand(b, h + top + bottom, w + left + right,
                                     c3).clone()
    full[:, top:top + h, left:left + w] = qkv
    q, k, v = _partition(full, window, 3, heads).unbind(0)
    n = window * window
    rel = relative_position_index(window).to(qkv.device).reshape(-1)
    bias_hnn = table.to(torch.float32)[rel].view(n, n, heads).permute(2, 0, 1)
    s = (q @ k.transpose(-1, -2)) * (d ** -0.5) + bias_hnn
    lse = torch.logsumexp(s, dim=-1)
    return q, k, v, torch.exp(s - lse[..., None]), lse, pads


def window_attention_plain(qkv: torch.Tensor, bias: torch.Tensor,
                           table: torch.Tensor, heads: int, window: int):
    """The kernels' function in plain PyTorch: (out (B, H, W, C) in qkv's
    dtype, lse (B * windows, heads, window^2) f32, the softmax's log-sum
    per query). Explicit pad with the bias (rounded to qkv's dtype, as the
    projection gives it), window partition, gathered bias, f32 softmax."""
    b, h, w, _ = qkv.shape
    _, _, v, p, lse, (top, bottom, left, right) = _plain_scores(
        qkv, bias, table, heads, window)
    o = _merge((p @ v)[None], b, h + top + bottom, w + left + right, window)
    return o[:, top:top + h, left:left + w].to(qkv.dtype).contiguous(), lse


def window_attention_plain_backward(grad_out, qkv, bias, table, heads: int,
                                    window: int):
    """Gradients of `window_attention_plain`'s output with respect to
    (qkv, bias, table), in f32 and written out: dV = P^T dO, dP = dO V^T,
    dS = P (dP - rowsum(P dP)), dQ = scale dS K, dK = scale dS^T Q; the
    table's gradient is dS summed by table row, the bias' the padded
    tokens' gradients. Returns (dqkv in qkv's dtype, dbias f32, dtable
    f32)."""
    b, h, w, _ = qkv.shape
    _, d = _dims(qkv, heads)
    q, k, v, p, _, (top, bottom, left, right) = _plain_scores(
        qkv, bias, table, heads, window)
    hp, wp = h + top + bottom, w + left + right
    g = grad_out.new_zeros((b, hp, wp, grad_out.shape[-1]),
                           dtype=torch.float32)
    g[:, top:top + h, left:left + w] = grad_out
    do = _partition(g, window, 1, heads)[0]
    dp = do @ v.transpose(-1, -2)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    scale = d ** -0.5
    dfull = _merge(torch.stack([ds @ k * scale,
                                ds.transpose(-1, -2) @ q * scale,
                                p.transpose(-1, -2) @ do]), b, hp, wp, window)
    real = torch.zeros((hp, wp), dtype=torch.bool, device=qkv.device)
    real[top:top + h, left:left + w] = True
    dbias = dfull[:, ~real].sum(dim=(0, 1))
    n = window * window
    rel = relative_position_index(window).to(qkv.device).reshape(-1)
    dtable = torch.zeros((table.shape[0], heads), dtype=torch.float32,
                         device=qkv.device).index_add_(
        0, rel, ds.sum(0).permute(1, 2, 0).reshape(n * n, heads))
    dqkv = dfull[:, top:top + h, left:left + w].to(qkv.dtype).contiguous()
    return dqkv, dbias, dtable


# -- the kernels -------------------------------------------------------------

def _check_launch(qkv, bias, table, heads: int, window: int) -> tuple:
    if qkv.dtype not in _DTYPES:
        raise ValueError(f"window_attention: qkv must be float32 or "
                         f"bfloat16 on a card, got {qkv.dtype}")
    check_cuda_tensor("qkv", qkv, qkv.dtype, 4)
    c, d = _dims(qkv, heads)
    if window != KERNEL_WINDOW or d > MAX_HEAD_DIM:
        raise ValueError(f"window_attention: the kernel takes {KERNEL_WINDOW}"
                         f"x{KERNEL_WINDOW} windows and head dims up to "
                         f"{MAX_HEAD_DIM}, got window {window}, head dim {d}")
    check_cuda_tensor("bias", bias, torch.float32, 1)
    check_cuda_tensor("table", table, torch.float32, 2)
    n_rel = (2 * window - 1) ** 2
    if bias.numel() != 3 * c or tuple(table.shape) != (n_rel, heads):
        raise ValueError(f"window_attention: bias {tuple(bias.shape)} and "
                         f"table {tuple(table.shape)} do not fit C={c}, "
                         f"{heads} heads")
    return c, d


def _geometry(qkv, heads: int, window: int) -> list:
    b, h, w, c3 = qkv.shape
    top, _, left, _ = centre_pad(h, w, window)
    nh, nw = num_windows(h, w, window)
    return [b, h, w, c3 // 3, heads, top, left, nh, nw]


def kernel_route(dtype: torch.dtype) -> str:
    """"mma" (the tensor-core kernels) for bf16, "simt" for f32."""
    return "mma" if dtype == torch.bfloat16 else "simt"


def mma_blocks(windows: int, heads: int, resident: int) -> int:
    """Blocks each head's windows are spread over (the mma grid's x), of
    the `resident` blocks the card holds at once in all: about
    resident / heads, each walking the same number of windows (the last
    fewer). A function of the shapes and the kernel's residency on the
    card, so the backward's order of sums is too."""
    per_head = -(-resident // heads)
    per_block = -(-windows // max(1, min(windows, per_head)))
    return -(-windows // per_block)


@functools.cache
def mma_resident(device: int, backward: bool) -> int:
    """Blocks of the mma forward's (backward's) kernel that card `device`
    holds at once over all its SMs, as the kernel's registers, launch
    bounds and shared memory allow (`advmix_window_attn_resident`). Asked
    once a process, at the first call, before any graph capture."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = library().advmix_window_attn_resident(
            int(backward), ctypes.addressof(blocks))
    check_status("window_attn_resident", rc)
    return blocks.value


def backward_groups(windows: int, heads: int) -> int:
    """Blocks a head's backward spreads its windows over: about four
    resident blocks on each of the H100's 132 SMs in all, and no more
    than there are windows."""
    return max(1, min(windows, -(-528 // heads)))


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


@torch.library.custom_op("advmix_tpu_torch::window_attn", mutates_args=())
def _attn_op(qkv: torch.Tensor, bias: torch.Tensor, table: torch.Tensor,
             heads: int, window: int) -> tuple[torch.Tensor, torch.Tensor]:
    if qkv.device.type != "cpu":
        raise RuntimeError(f"window_attention: no kernel for a "
                           f"{qkv.device.type} tensor")
    return window_attention_plain(qkv, bias, table, heads, window)


def _counted(route: str, launches: int) -> None:
    window_attention.launches += launches
    window_attention.routes[route] += launches
    for _ in range(launches):
        count("window_attn")
    if route == "mma":
        count("window_attn_mma")


@_attn_op.register_kernel("cuda")
def _attn_cuda(qkv, bias, table, heads, window):
    c, d = _check_launch(qkv, bias, table, heads, window)
    geo = _geometry(qkv, heads, window)
    nwin = geo[0] * geo[7] * geo[8]
    route = kernel_route(qkv.dtype)
    blocks = (mma_blocks(nwin, heads, mma_resident(qkv.device.index, False))
              if route == "mma" else 0)
    out = torch.empty(qkv.shape[:3] + (c,), dtype=qkv.dtype,
                      device=qkv.device)
    lse = torch.empty((nwin, heads, window * window), dtype=torch.float32,
                      device=qkv.device)
    if out.numel():
        with torch.cuda.device(qkv.device):
            rc = library().advmix_window_attn_fwd(
                qkv.data_ptr(), bias.data_ptr(), table.data_ptr(),
                out.data_ptr(), lse.data_ptr(), *geo,
                ctypes.c_float(d ** -0.5), _DTYPES[qkv.dtype], blocks,
                _stream(qkv))
        check_status("window_attn_fwd", rc)
        _counted(route, 1)
    return out, lse


@_attn_op.register_fake
def _attn_fake(qkv, bias, table, heads, window):
    b, h, w, c3 = qkv.shape
    nh, nw = num_windows(h, w, window)
    return (qkv.new_empty((b, h, w, c3 // 3)),
            qkv.new_empty((b * nh * nw, heads, window * window),
                          dtype=torch.float32))


@torch.library.custom_op("advmix_tpu_torch::window_attn_backward",
                         mutates_args=())
def _attn_bwd_op(grad_out: torch.Tensor, qkv: torch.Tensor,
                 bias: torch.Tensor, table: torch.Tensor, lse: torch.Tensor,
                 heads: int, window: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if qkv.device.type != "cpu":
        raise RuntimeError(f"window_attention: no kernel for a "
                           f"{qkv.device.type} tensor")
    return window_attention_plain_backward(grad_out, qkv, bias, table, heads,
                                           window)


@_attn_bwd_op.register_kernel("cuda")
def _attn_bwd_cuda(grad_out, qkv, bias, table, lse, heads, window):
    c, d = _check_launch(qkv, bias, table, heads, window)
    check_cuda_tensor("grad_out", grad_out, qkv.dtype, 4)
    geo = _geometry(qkv, heads, window)
    nwin = geo[0] * geo[7] * geo[8]
    check_cuda_tensor("lse", lse, torch.float32, 3)
    if tuple(grad_out.shape) != tuple(qkv.shape[:3]) + (c,) or \
            tuple(lse.shape) != (nwin, heads, window * window):
        raise ValueError("window_attention backward: grad_out "
                         f"{tuple(grad_out.shape)} or lse {tuple(lse.shape)} "
                         f"do not fit qkv {tuple(qkv.shape)}")
    route = kernel_route(qkv.dtype)
    groups = (mma_blocks(nwin, heads, mma_resident(qkv.device.index, True))
              if route == "mma" else backward_groups(nwin, heads))
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty(3 * c, dtype=torch.float32, device=qkv.device)
    dtable = torch.empty_like(table)
    partial = torch.empty((heads, groups, table.shape[0] + 2 * d),
                          dtype=torch.float32, device=qkv.device)
    with torch.cuda.device(qkv.device):
        rc = library().advmix_window_attn_bwd(
            grad_out.data_ptr(), qkv.data_ptr(), bias.data_ptr(),
            table.data_ptr(), lse.data_ptr(), dqkv.data_ptr(),
            partial.data_ptr(), dtable.data_ptr(), dbias.data_ptr(), *geo,
            ctypes.c_float(d ** -0.5), _DTYPES[qkv.dtype], groups,
            _stream(qkv))
    check_status("window_attn_bwd", rc)
    _counted(route, 2)
    return dqkv, dbias, dtable


@_attn_bwd_op.register_fake
def _attn_bwd_fake(grad_out, qkv, bias, table, lse, heads, window):
    return (torch.empty_like(qkv), bias.new_empty(bias.shape),
            torch.empty_like(table))


class _WindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, bias, table, heads, window):
        out, lse = torch.ops.advmix_tpu_torch.window_attn(qkv, bias, table,
                                                          heads, window)
        ctx.save_for_backward(qkv, bias, table, lse)
        ctx.heads, ctx.window = heads, window
        return out

    @staticmethod
    def backward(ctx, grad_out):
        qkv, bias, table, lse = ctx.saved_tensors
        dqkv, dbias, dtable = torch.ops.advmix_tpu_torch.window_attn_backward(
            grad_out.contiguous(), qkv, bias, table, lse, ctx.heads,
            ctx.window)
        return dqkv, dbias, dtable, None, None


def window_attention(qkv: torch.Tensor, bias: torch.Tensor | None,
                     table: torch.Tensor, heads: int,
                     window: int) -> torch.Tensor:
    """(B, H, W, C) attention output of the qkv projection's output
    (B, H, W, 3C), its bias (3C; None: no bias) and the bias table
    ((2 window - 1)^2, heads): the kernels for a CUDA tensor, the plain
    version for a CPU tensor, with gradients to all three. The bias and
    the table are read in f32 (a bf16 teacher's cast back exactly)."""
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"qkv must be a CPU or CUDA tensor, got "
                         f"{qkv.device}")
    if bias is None:
        bias = qkv.new_zeros(qkv.shape[-1], dtype=torch.float32)
    with span("advmix.window_attn"):
        return _WindowAttention.apply(qkv.contiguous(),
                                      bias.to(torch.float32),
                                      table.to(torch.float32), int(heads),
                                      int(window))


window_attention.launches = 0
window_attention.routes = {"mma": 0, "simt": 0}
