"""Post-training int8 quantization (W8A8) for evaluation, the KD teacher
and serving.

Port of `advmix_tpu/ops/quant.py`. Symmetric int8: per-output-channel
weight scales (max |w| / 127 over I, kh, kw of the OIHW weight) and one
activation scale per convolution, calibrated offline (abs-max or a
percentile of |x| over calibration batches, times `margin`). The product
is summed exactly in int32, then rescaled to f32 once per convolution, the
bias added in f32, and the result cast to the dtype the replaced
convolution computed in. BatchNorm, ReLU and the residual adds stay in the
model's compute dtype.

The JAX package swaps convolutions with a flax method interceptor keyed by
scope path. Here `quantize_model` swaps each supported `nn.Conv2d` of a
deep copy for a `QuantConv2d`, keyed by the module's name
(`layer1.0.conv1`); `scales_from_jax` and `prequantized_from_jax` carry
the JAX package's path-keyed scales and int8 kernels over through
`models/convert.flax_module_name`. Skipping stays substring matching, with
`DEFAULT_SKIP = ("final_layer",)`, which also catches HigherHRNet's
`final_layers.*`. Transposed convolutions stay unquantized.

The int8 product is the custom op `advmix_tpu_torch::int8_conv2d`
(`ops/int8_conv.py`).

Rounding follows the JAX package: an activation is multiplied by
`1.0 / scale` (a Python double, applied in f32) and rounded half to even;
the rescale multiplies the int32 sums, cast to f32, by the f32 vector
`w_scale * act_scale`, then adds the bias in f32. The weight scale is the
true quotient absmax / 127 (a division by a 0-dim tensor, so the card and
the CPU agree), as the JAX function computes it outside a jit
(`prequantize_params`, an eager `apply`); inside a jit XLA multiplies by
the reciprocal of 127, which can put a scale an ulp away.

Quantize from f32 weights: a model cast with
`set_compute_dtype(..., trainable=False)` has bf16 convolution weights,
and `quantize_model` refuses it.
"""

from __future__ import annotations

import copy
import warnings
from typing import Callable, Iterable, Mapping

import numpy as np
import torch
from torch import nn

from ..models.layers import set_compute_dtype
from .int8_conv import int8_conv2d  # noqa: F401  (registers the op)

DEFAULT_SKIP = ("final_layer",)
def _make_skip_fn(skip) -> Callable[[str], bool]:
    if skip is None:
        skip = DEFAULT_SKIP
    if callable(skip):
        return skip
    subs = tuple(skip)
    return lambda path: any(s in path for s in subs)


def supported(mod: nn.Module) -> bool:
    """The plain 2-D convolutions the pose models use: groups 1, no
    dilation, zero padding given as numbers (`quant.py:_supported`)."""
    return (isinstance(mod, nn.Conv2d) and mod.groups == 1
            and tuple(mod.dilation) == (1, 1)
            and mod.padding_mode == "zeros"
            and not isinstance(mod.padding, str))


def conv_paths(model: nn.Module, skip=None) -> list[str]:
    """Names of the convolutions `quantize_model` would consider."""
    skip_fn = _make_skip_fn(skip)
    return [n for n, m in model.named_modules()
            if supported(m) and not skip_fn(n)]


# ---------------------------------------------------------------------------
# Quantizers
# ---------------------------------------------------------------------------

def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of an OIHW weight:
    w ~= wq * scale[:, None, None, None]. Returns (wq int8, scale f32 (O,))."""
    w = w.detach().to(torch.float32)
    absmax = w.abs().amax(dim=(1, 2, 3))
    scale = absmax.clamp(min=1e-12) / torch.tensor(127.0, device=w.device)
    wq = torch.round(w / scale[:, None, None, None]).clamp_(-127, 127)
    return wq.to(torch.int8), scale


def quantize_activation(x: torch.Tensor, scale: float) -> torch.Tensor:
    xq = torch.round(x.to(torch.float32) * (1.0 / float(scale)))
    return xq.clamp_(-127, 127).to(torch.int8)


class QuantConv2d(nn.Module):
    """W8A8 replacement of one `nn.Conv2d` (`quant.py:_quantized_conv`).

    With an f32 weight it quantizes the weight on every call, as the JAX
    package quantizes the live params inside the traced function; with an
    int8 weight (a prequantized model) it takes the per-channel `w_scale`
    given beside it and stores both as buffers. Output: the rescaled sums
    plus the f32 bias, in the input's dtype, NCHW."""

    def __init__(self, conv: nn.Conv2d, act_scale: float,
                 w_scale: torch.Tensor | None = None):
        super().__init__()
        self.stride = [int(s) for s in conv.stride]
        self.padding = [int(p) for p in conv.padding]
        self.act_scale = float(act_scale)
        weight = conv.weight.detach()
        if weight.dtype == torch.int8:
            if w_scale is None:
                raise ValueError(
                    "int8 weight without a weight scale: pass the w_scales "
                    "mapping from prequantize_params to quantize_model")
            self.register_buffer("weight", weight.clone())
            self.register_buffer("w_scale", torch.as_tensor(
                w_scale, dtype=torch.float32, device=weight.device).clone())
        else:
            if weight.dtype not in (torch.float32, torch.float64):
                raise ValueError(
                    f"quantize from the f32 weights, not {weight.dtype}: "
                    "call before set_compute_dtype(..., trainable=False)")
            self.weight = nn.Parameter(weight.clone(), requires_grad=False)
            self.register_buffer("w_scale", None)
        self.bias = None if conv.bias is None else nn.Parameter(
            conv.bias.detach().to(torch.float32).clone(),
            requires_grad=False)

    @property
    def prequantized(self) -> bool:
        return self.weight.dtype == torch.int8

    def bake(self) -> torch.Tensor:
        """Quantize the f32 weight once into int8 and scale buffers
        (`prequantize_params`). Returns the scale."""
        if self.prequantized:
            return self.w_scale
        wq, scale = quantize_weight(self.weight)
        del self.weight
        self.register_buffer("weight", wq)
        self.register_buffer("w_scale", scale)
        return scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.prequantized:
            wq, w_scale = self.weight, self.w_scale
        else:
            wq, w_scale = quantize_weight(self.weight)
        xq = quantize_activation(x, self.act_scale)
        acc = torch.ops.advmix_tpu_torch.int8_conv2d(xq, wq, self.stride,
                                                     self.padding)
        # int32 * f32 computes in f32: the cast and the product, one kernel
        out = acc * (w_scale * self.act_scale)
        if self.bias is not None:
            out = out + self.bias
        # NHWC f32 -> NCHW in the input's dtype, one copy
        return out.permute(0, 3, 1, 2).to(
            x.dtype, memory_format=torch.contiguous_format)

    def extra_repr(self) -> str:
        return (f"{tuple(self.weight.shape)}, stride={self.stride}, "
                f"padding={self.padding}, act_scale={self.act_scale:.6g}, "
                f"prequantized={self.prequantized}")


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------

def _model_dtype(model: nn.Module) -> torch.dtype:
    """The dtype the model computes its convolutions in: the recorded
    compute dtype, else the first convolution's weight dtype."""
    dt = getattr(model, "compute_dtype", None)
    if dt is not None:
        return dt
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, QuantConv2d)) \
                and m.weight.is_floating_point():
            return m.weight.dtype
    return torch.float32


@torch.no_grad()
def calibrate_act_scales(model: nn.Module, batches: Iterable[torch.Tensor],
                         method: str = "absmax", percentile: float = 99.9,
                         skip=None, margin: float = 1.0) -> dict[str, float]:
    """Run the eval-mode model on NCHW calibration batches, recording each
    supported, unskipped convolution's input range. Returns {module name:
    range / 127 * margin}. "absmax": the max |x| over all batches;
    "percentile": the given percentile of |x| pooled over batches, from the
    NHWC flattening subsampled with stride size >> 20 where it holds more
    than 2^20 values (`quant.py:240-247`)."""
    if method not in ("absmax", "percentile"):
        raise ValueError(f"method must be 'absmax' or 'percentile': {method}")
    skip_fn = _make_skip_fn(skip)
    maxima: dict[str, torch.Tensor] = {}
    samples: dict[str, list] = {}

    def hook_for(path):
        def hook(_mod, args):
            x = args[0].detach()
            if method == "absmax":
                m = x.abs().amax().to(torch.float32)
                maxima[path] = (torch.maximum(maxima[path], m)
                                if path in maxima else m)
            else:
                flat = x.permute(0, 2, 3, 1).reshape(-1)
                if flat.numel() > 1 << 20:
                    flat = flat[:: (flat.numel() >> 20) or 1]
                samples.setdefault(path, []).append(
                    flat.abs().to(torch.float32).cpu().numpy())
        return hook

    handles = [m.register_forward_pre_hook(hook_for(n))
               for n, m in model.named_modules()
               if supported(m) and not skip_fn(n)]
    was_training = model.training
    model.eval()
    try:
        for batch in batches:
            model(batch)
    finally:
        for h in handles:
            h.remove()
        model.train(was_training)
    if method == "absmax":
        ranges = {p: float(m) for p, m in maxima.items()}
    else:
        ranges = {p: float(np.percentile(np.concatenate(v), percentile))
                  for p, v in samples.items()}
    return {p: max(r, 1e-12) / 127.0 * float(margin)
            for p, r in ranges.items()}


def normalize_images(image_u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> normalized f32 NCHW, as the eval preprocessor
    normalizes (`engine/trainer.make_eval_preprocessor`)."""
    from .augment import IMAGENET_MEAN, IMAGENET_STD

    dev = image_u8.device
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=dev) * 255.0
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=dev) * 255.0
    return ((image_u8.to(torch.float32) - mean) / std).permute(0, 3, 1, 2)


def calibrate_from_loader(model: nn.Module, loader, n_batches: int,
                          device: torch.device, **calib_kwargs
                          ) -> dict[str, float]:
    """The CLI calibration path (`tools/export.py --int8`, TEST.INT8,
    TRAIN.INT8_TEACHER): the first `n_batches` host batches of `loader`
    ("image" uint8 NHWC), normalized on `device`, through
    `calibrate_act_scales`."""
    calib = []
    for i, b in enumerate(loader):
        if i >= int(n_batches):
            break
        calib.append(normalize_images(torch.as_tensor(b["image"]).to(device)))
    if not calib:
        raise ValueError("int8 calibration: no batches available")
    return calibrate_act_scales(model, calib, **calib_kwargs)


# ---------------------------------------------------------------------------
# The quantized model
# ---------------------------------------------------------------------------

def quantize_model(model: nn.Module, act_scales: Mapping[str, float],
                   skip=None, fallback_scale: float | None = None,
                   w_scales: Mapping[str, torch.Tensor] | None = None
                   ) -> nn.Module:
    """A frozen, eval-mode deep copy of `model` whose supported, unskipped
    convolutions with a calibrated scale (or `fallback_scale`) run W8A8
    (`quant.py:make_quantized_apply`). The copy computes in the model's
    compute dtype; its other convolutions are cast to it. A convolution
    whose weight is already int8 takes its scale from `w_scales`.
    `.quantized_paths` holds the names swapped. It warns when nothing
    matched, or when a calibrated name matched no convolution: those
    convolutions would run unquantized."""
    skip_fn = _make_skip_fn(skip)
    dtype = _model_dtype(model)
    q = copy.deepcopy(model).eval()
    quantized: set = set()
    for name, mod in list(q.named_modules()):
        if not supported(mod) or skip_fn(name):
            continue
        scale = act_scales.get(name, fallback_scale)
        if scale is None:
            continue
        ws = w_scales.get(name) if w_scales else None
        parent_name, _, leaf = name.rpartition(".")
        parent = q.get_submodule(parent_name) if parent_name else q
        setattr(parent, leaf, QuantConv2d(mod, float(scale), ws))
        quantized.add(name)
    set_compute_dtype(q, dtype)
    q.compute_dtype = dtype  # the first conv may now hold int8 weights
    unmatched = sorted(set(act_scales) - quantized)
    if not quantized:
        warnings.warn(
            "int8 quantized ZERO convs: none of the "
            f"{len(act_scales)} calibrated paths matched a conv in this "
            "model (another model, or renamed modules?); the 'int8' "
            "forward is running unquantized", stacklevel=2)
    elif unmatched:
        warnings.warn(
            f"int8: {len(unmatched)} calibrated path(s) never matched any "
            f"conv (first: {unmatched[:3]}); those convs are running "
            "unquantized", stacklevel=2)
    q.quantized_paths = quantized
    return q


def prequantize_params(model: nn.Module, act_scales: Mapping[str, float],
                       skip=None) -> tuple[nn.Module, dict]:
    """`quantize_model` with every swapped weight quantized once into an
    int8 buffer, its per-channel scale a buffer beside it (4x smaller
    serving weights, no per-call weight quantization). Returns (the
    quantized model, {name: scale}). Its state dict no longer loads into
    the f32 model: it is a serving artifact."""
    q = quantize_model(model, act_scales, skip=skip)
    w_scales = {name: q.get_submodule(name).bake()
                for name in sorted(q.quantized_paths)}
    return q, w_scales


# ---------------------------------------------------------------------------
# The KD teacher
# ---------------------------------------------------------------------------

def make_int8_teacher(model_d: nn.Module, act_scales: Mapping[str, float],
                      skip=None) -> nn.Module:
    """The W8A8 KD teacher (TRAIN.INT8_TEACHER, `quant.py:
    make_int8_teacher_apply`): a frozen, eval-mode quantized copy of D,
    from D's f32 master weights. Its KD target is the int8-rounded
    teacher heatmap: opt-in."""
    return quantize_model(model_d, act_scales, skip=skip)


def int8_teacher_from_config(dtype: torch.dtype, model_d: nn.Module, *,
                             device: torch.device, loader=None,
                             n_batches: int = 2, margin: float = 1.0,
                             calib_images=None):
    """One-stop TRAIN.INT8_TEACHER constructor for `tools/train.py` and
    `tools/bench.py`: calibrates a copy of D (f32 weights, computing in
    `dtype`) from `loader` ("image" uint8 batches, `calibrate_from_loader`)
    or from `calib_images` (normalized NCHW tensors), then quantizes it.
    Returns (teacher, act_scales). The port has no scanned layout, so the
    JAX function's config (read to build the unscanned model) and its
    unscan step fall away."""
    calib = copy.deepcopy(model_d).to(device).eval()
    set_compute_dtype(calib, dtype, trainable=True)
    if loader is not None:
        act_scales = calibrate_from_loader(calib, loader, n_batches, device,
                                           margin=margin)
    else:
        if not calib_images:
            raise ValueError("int8 teacher: pass loader= or calib_images=")
        act_scales = calibrate_act_scales(calib, list(calib_images),
                                          margin=margin)
    del calib
    return make_int8_teacher(model_d, act_scales), act_scales


# ---------------------------------------------------------------------------
# Scales and int8 kernels of the JAX package
# ---------------------------------------------------------------------------

def _jax_leaf_to_name(model: nn.Module) -> dict:
    from ..models.convert import flax_module_name

    return {flax_module_name(n): n for n, m in model.named_modules()
            if isinstance(m, (nn.Conv2d, QuantConv2d))}


def scales_from_jax(act_scales: Mapping[str, float],
                    model: nn.Module) -> dict[str, float]:
    """The JAX package's {"/"-joined flax path: scale} as {module name:
    scale} of the port's `model`. Raises for a path with no convolution."""
    by_leaf = _jax_leaf_to_name(model)
    out = {}
    for path, s in act_scales.items():
        leaf = path.rsplit("/", 1)[-1]
        if leaf not in by_leaf:
            raise KeyError(f"no convolution of the port for JAX path {path}")
        out[by_leaf[leaf]] = float(s)
    return out


def prequantized_from_jax(params: Mapping[str, np.ndarray],
                          w_scales: Mapping[str, np.ndarray],
                          model: nn.Module) -> tuple[dict, dict]:
    """The JAX package's prequantized variables, flattened to "/"-joined
    paths (params with int8 HWIO kernels, and batch_stats), and its
    {path: per-channel scale}, as (a state dict for the port's
    prequantized copy of the f32 `model`, {module name: scale}): int8
    OIHW weights and f32 scales, the rest as `jax_to_torch_state_dict`
    maps it."""
    from ..models.convert import jax_to_torch_state_dict

    state = jax_to_torch_state_dict(dict(params), model)
    scales = {}
    by_leaf = _jax_leaf_to_name(model)
    for path, s in w_scales.items():
        name = by_leaf[path.rsplit("/", 1)[-1]]
        codes = state[name + ".weight"]
        state[name + ".weight"] = codes.to(torch.int8)
        if name + ".bias" in state:  # QuantConv2d keeps its bias f32
            state[name + ".bias"] = state[name + ".bias"].to(torch.float32)
        state[name + ".w_scale"] = torch.from_numpy(
            np.asarray(s, np.float32).copy())
        scales[name] = state[name + ".w_scale"]
    return state, scales
