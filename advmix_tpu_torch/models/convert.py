"""JAX variables -> the port's torch state_dict.

The input is the JAX package's `params` and `batch_stats` flattened to
'/'-joined paths (`params/stage2_0/.../stage2_0_branches_0_0_conv1/kernel`),
as `np.savez` of those trees stores them. Every leaf flax module in the JAX
package is named after the torch module path with '.' replaced by '_', so
the mapping is by that leaf-module name plus layout changes; it is the
inverse of `advmix_tpu/models/torch_convert.py:147-178`:

- conv / transposed-conv `kernel` (kh, kw, I, O) -> `weight` (O, I, kh, kw)
  (one permutation covers both, as in the forward converter);
- BN `scale`/`bias` -> `weight`/`bias`; `batch_stats` `mean`/`var` ->
  `running_mean`/`running_var`.

The scanned layout (MODEL.EXTRA.USE_SCAN) is unstacked first, with this
module's own copy of the JAX package's unstacking rules
(`torch_convert.py:213-301`): `stage<si>_scan/mod/...` carries a module
axis, `..._branches_<i>_scan/block/...` and ResNet `layer<k>_scan/block/...`
a block axis; HRNet branch scans count blocks from 0, ResNet tails from 1,
and stage 4's last module is never scanned.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _is_scan(path, i, child) -> bool:
    return path[i].endswith("_scan") and i + 1 < len(path) \
        and path[i + 1] == child


def _scan_kinds(path):
    return (any(_is_scan(path, i, "mod") for i in range(len(path))),
            any(_is_scan(path, i, "block") for i in range(len(path))))


def _resolve_scan_path(path, stage_m=None, block_b=None):
    """Map a scanned variable path to its unscanned path for the given
    (stage module, block) indices."""
    out = []
    i = 0
    stage_prefix = branch_prefix = None
    while i < len(path):
        p = path[i]
        if _is_scan(path, i, "mod"):
            stage_prefix = p[: -len("_scan")] + f"_{stage_m}"
            out.append(stage_prefix)
            i += 2
            continue
        if _is_scan(path, i, "block"):
            base = p[: -len("_scan")]
            if base.startswith("mod"):
                base = base.replace("mod", stage_prefix, 1)
            # ResNet tails start at block 1 (block 0 downsamples and stays
            # unscanned); HRNet branch scans start at 0
            start = 0 if ("_branches_" in p or p.startswith("mod")) else 1
            branch_prefix = base + f"_{block_b + start}"
            out.append(branch_prefix)
            i += 2
            continue
        if p.startswith("mod_") and stage_prefix is not None:
            out.append(p.replace("mod", stage_prefix, 1))
        elif p.startswith("block_") and branch_prefix is not None:
            out.append(p.replace("block", branch_prefix, 1))
        else:
            out.append(p)
        i += 1
    return tuple(out)


def unstack_scanned(flat: dict) -> dict:
    """{path tuple: array} in either layout -> the unscanned layout."""
    out = {}
    for path, val in flat.items():
        has_stage, has_block = _scan_kinds(path)
        val = np.asarray(val)
        if has_stage and has_block:
            for m in range(val.shape[0]):
                for b in range(val.shape[1]):
                    out[_resolve_scan_path(path, m, b)] = val[m, b]
        elif has_block:
            for b in range(val.shape[0]):
                out[_resolve_scan_path(path, None, b)] = val[b]
        elif has_stage:
            for m in range(val.shape[0]):
                out[_resolve_scan_path(path, m, None)] = val[m]
        else:
            out[path] = val
    return out


_LEAVES = {
    # torch leaf -> (collection, flax leaf) by the kind of flax module
    ("conv", "weight"): ("params", "kernel"),
    ("conv", "bias"): ("params", "bias"),
    ("bn", "weight"): ("params", "scale"),
    ("bn", "bias"): ("params", "bias"),
    ("bn", "running_mean"): ("batch_stats", "mean"),
    ("bn", "running_var"): ("batch_stats", "var"),
}


def jax_to_torch_state_dict(flat: dict, model: nn.Module) -> dict:
    """Build a `load_state_dict(strict=True)`-ready state dict for `model`
    from '/'-joined JAX variable paths. Raises if a model key has no JAX
    leaf, a shape differs, or a JAX leaf is left unused."""
    by_module: dict = {}
    for key, val in unstack_scanned(
            {tuple(k.split("/")): v for k, v in flat.items()}).items():
        coll, mod, leaf = key[0], key[-2], key[-1]
        by_module.setdefault(mod, {})[(coll, leaf)] = val
    used = set()
    state = {}
    for tkey, cur in model.state_dict().items():
        if tkey.endswith("num_batches_tracked"):
            state[tkey] = cur.clone()
            continue
        mod_path, _, leaf = tkey.rpartition(".")
        mod = mod_path.replace(".", "_")
        entry = by_module.get(mod, {})
        kind = "conv" if ("params", "kernel") in entry else "bn"
        src = _LEAVES.get((kind, leaf))
        if src is None or src not in entry:
            raise KeyError(f"no JAX variable for {tkey} (module {mod})")
        arr = entry[src]
        if src[1] == "kernel":
            arr = np.transpose(arr, (3, 2, 0, 1))
        if tuple(arr.shape) != tuple(cur.shape):
            raise ValueError(f"{tkey}: JAX shape {arr.shape} != "
                             f"{tuple(cur.shape)}")
        state[tkey] = torch.from_numpy(np.ascontiguousarray(arr)).to(cur.dtype)
        used.add((mod, src))
    unused = [f"{c}/{m}/{lf}" for m, e in by_module.items()
              for (c, lf) in e if (m, (c, lf)) not in used]
    if unused:
        raise KeyError(f"JAX variables with no torch key: {unused[:10]}")
    return state


# ---------------------------------------------------------------------------
# UNet generator, and the reverse direction
# ---------------------------------------------------------------------------

def unet_torch_key(depth: int, kind: str, num_downs: int = 6) -> str:
    """Key prefix of the nested UnetGenerator's conv at `depth` (0 =
    outermost), `kind` "down" or "up": the JAX package names the same conv
    `down_<depth>_conv` / `up_<depth>_conv`
    (`advmix_tpu/models/torch_convert.py:353-366`)."""
    if depth == 0:
        return "model.model.0" if kind == "down" else "model.model.3"
    prefix = "model.model.1." + "model.3." * (depth - 1)
    if kind == "down":
        return prefix + "model.1"
    return prefix + ("model.3" if depth == num_downs - 1 else "model.5")


def jax_unet_to_torch_state_dict(flat: dict, model: nn.Module) -> dict:
    """State dict of the port's `UnetGenerator` from the flax G's params as
    '/'-joined paths (`params/down_0_conv/kernel`, with or without the
    leading `params/`). Conv kernels (kh, kw, I, O) and transposed-conv
    kernels (kh, kw, O, I; flax `transpose_kernel=True`) both become torch's
    layout by the one permutation (3, 2, 0, 1), with no spatial flip."""
    by_mod = {tuple(k.split("/")[-2:]): np.asarray(v) for k, v in flat.items()}
    n = model.num_downs
    state = {}
    for d in range(n):
        for kind in ("down", "up"):
            base = unet_torch_key(d, kind, n)
            mod = f"{kind}_{d}_conv"
            state[base + ".weight"] = torch.from_numpy(np.ascontiguousarray(
                np.transpose(by_mod[mod, "kernel"], (3, 2, 0, 1))))
            state[base + ".bias"] = torch.from_numpy(
                np.ascontiguousarray(by_mod[mod, "bias"]))
    cur = model.state_dict()
    if set(cur) != set(state) or len(by_mod) != len(state):
        raise KeyError("flax UNet params do not cover the torch UNet's keys")
    for k, v in state.items():
        if tuple(v.shape) != tuple(cur[k].shape):
            raise ValueError(f"{k}: JAX shape {tuple(v.shape)} != "
                             f"{tuple(cur[k].shape)}")
        state[k] = v.to(cur[k].dtype)
    return state


def torch_to_jax_leaves(model: nn.Module) -> dict:
    """The reverse mapping, for comparing trained models leaf by leaf:
    {"<collection>/<flax leaf module>/<leaf>": numpy array in the flax
    layout} for a pose network or a `UnetGenerator`. The parents of a flax
    leaf module are left out (their names repeat its prefix)."""
    from .unet import UnetGenerator

    back = {v: k for k, v in _LEAVES.items()}
    unet = {}
    if isinstance(model, UnetGenerator):
        n = model.num_downs
        unet = {unet_torch_key(d, kind, n): f"{kind}_{d}_conv"
                for d in range(n) for kind in ("down", "up")}
    kinds = {name: ("bn" if isinstance(m, nn.modules.batchnorm._BatchNorm)
                    else "conv") for name, m in model.named_modules()}
    out = {}
    for tkey, val in model.state_dict().items():
        if tkey.endswith("num_batches_tracked"):
            continue
        mod_path, _, leaf = tkey.rpartition(".")
        coll, fleaf = _LEAVES[kinds[mod_path], leaf]
        arr = val.detach().cpu().numpy()
        if fleaf == "kernel":
            arr = np.transpose(arr, (2, 3, 1, 0))
        mod = unet.get(mod_path, mod_path.replace(".", "_"))
        out[f"{coll}/{mod}/{fleaf}"] = arr
    return out
