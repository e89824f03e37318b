"""Serving export: the inference function as a `torch.export` program.

    python -m advmix_tpu_torch.tools.export --cfg <yaml> \
        [TEST.MODEL_FILE <weights>] [--batch 128] [--out DIR] [--int8 \
        [--calib images.npy]] [--device cpu] [KEY VALUE ...]

Port of `tools/export.py`, with `torch.export` in the place of
`jax.export`. The program takes normalized NHWC float32 images (B, H, W,
3), the JAX module's wire format, and returns (B, J, 3) [x, y, score] in
heatmap coordinates: the forward, the flip-test ensemble and the decode
through the custom op `advmix_tpu_torch::decode_heatmaps` (the CUDA kernel
on the card). For MODEL.NAME pose_higher_hrnet it is the device half of
the bottom-up evaluation (`engine/steps.bottomup_infer_fn`): a dict of
`heat`, `tags` and the top-k `peak_x`, `peak_y`, `peak_val`, `peak_tag`,
which host grouping (`evaluation/grouping.py`) consumes.

`--batch N` exports a fixed batch; `--batch 0` a batch-polymorphic program
(a `torch.export.Dim` leading dimension). `--int8` exports the W8A8 model
(`ops/quant.py`) with its weights stored int8 beside their per-channel
scales, calibrated on `--calib` (an .npy of normalized NHWC images), else
on two val batches of the dataset, else on standard-normal images with a
warning; it is refused for a bottom-up config, as the JAX tool refuses it.
The tool writes `pose_infer.pt2` (`torch.export.save`, with its device,
batch and image size in `meta.json` inside it) and the weights beside it
(`final_state`; an int8 one is a serving artifact and does not load into
the f32 model, and `int8_scales.json` holds its activation scales), then
loads the program back and runs it, also at batch 7 when it is
polymorphic. The program's weights sit on the device it was
traced on: export on the serving device, the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import os
import types

import numpy as np
import torch
from torch import nn

from ..config import get_default_config, update_config
from ..data import Loader, build_dataset
from ..engine.checkpoint import export_final_state
from ..engine.steps import bottomup_infer_fn, make_eval_step
from ..models import get_pose_net
from ..models.layers import set_compute_dtype
from ..ops import quant
from ..ops.cuda.decode_kernel import decode_heatmaps
from ..utils.device import resolve_device
from ..utils.logging import create_logger
from ._parse import one_device_only, parse_args
from .validate import load_test_model_file

PROGRAM = "pose_infer.pt2"
META = "meta.json"
INT8_SCALES = "int8_scales.json"
BOTTOMUP_OUTPUTS = ("heat", "tags", "peak_x", "peak_y", "peak_val",
                    "peak_tag")


class TopDownInfer(nn.Module):
    """Normalized NHWC images -> (B, J, 3) [x, y, score] in heatmap
    coordinates: the eval step's forward (flip test, `flip_back`, the
    shift) and the decode kernel (`export.py:build_infer_fn`)."""

    def __init__(self, model: nn.Module, cfg, flip_pairs):
        super().__init__()
        self.model = model
        self.post = bool(cfg.TEST.POST_PROCESS)
        self._forward = make_eval_step(model, cfg, flip_pairs).forward

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        coords, maxvals = decode_heatmaps(self._forward(image), self.post)
        return torch.cat([coords, maxvals], dim=-1)


class BottomUpInfer(nn.Module):
    """Normalized NHWC images -> the dict of `BOTTOMUP_OUTPUTS`, the
    device half of the bottom-up evaluation."""

    def __init__(self, model: nn.Module, cfg, flip_pairs):
        super().__init__()
        self.model = model
        self._infer = bottomup_infer_fn(
            model, cfg, flip_pairs,
            scales=tuple(float(s) for s in cfg.TEST.SCALE_FACTOR))

    def forward(self, image: torch.Tensor) -> dict:
        heat, tags, peaks = self._infer(image)
        return {"heat": heat, "tags": tags, "peak_x": peaks["x"],
                "peak_y": peaks["y"], "peak_val": peaks["val"],
                "peak_tag": peaks["tag"]}


def build_infer_fn(model: nn.Module, cfg, flip_pairs) -> nn.Module:
    """The inference module of an eval-mode model, top-down or bottom-up."""
    if cfg.MODEL.NAME == "pose_higher_hrnet":
        return BottomUpInfer(model, cfg, flip_pairs)
    return TopDownInfer(model, cfg, flip_pairs)


def flip_pairs_of(cfg, logger):
    """(the val dataset or None, its flip pairs). Without the dataset a
    bottom-up config takes the COCO pairs, a top-down one none."""
    try:
        ds = build_dataset(cfg, False, None)
        return ds, ds.flip_pairs
    except Exception as e:  # no annotation files: export without them
        if cfg.MODEL.NAME == "pose_higher_hrnet":
            from ..data.bottomup import BottomUpCOCODataset

            return None, BottomUpCOCODataset.flip_pairs
        logger.warning(f"=> dataset unavailable ({e}); exporting without "
                       "flip pairs")
        return None, []


def int8_scales(model, cfg, ds, calib: str, device, logger) -> dict:
    """Activation scales for `--int8`: from the .npy `calib`, else two val
    batches of 16, else 16 standard-normal images."""
    w, h = cfg.MODEL.IMAGE_SIZE
    if calib:
        arr = np.load(calib).astype(np.float32)
        batches = [torch.from_numpy(arr[i:i + 16]).to(device).permute(
            0, 3, 1, 2) for i in range(0, len(arr), 16)]
        return quant.calibrate_act_scales(model, batches)
    if ds is not None:
        return quant.calibrate_from_loader(model, Loader(ds, 16), 2, device)
    logger.warning("=> --int8: no dataset and no --calib; calibrating on "
                   "standard-normal images (ranges may be loose)")
    x = np.random.RandomState(0).randn(16, h, w, 3).astype(np.float32)
    return quant.calibrate_act_scales(
        model, [torch.from_numpy(x).to(device).permute(0, 3, 1, 2)])


def main(argv=None):
    extra = argparse.ArgumentParser(add_help=False)
    extra.add_argument("--batch", type=int, default=128,
                       help="serving batch size; 0 exports a batch-"
                            "polymorphic program")
    extra.add_argument("--out", type=str, default="")
    extra.add_argument("--int8", action="store_true",
                       help="export the W8A8 int8 model (ops/quant.py)")
    extra.add_argument("--calib", type=str, default="",
                       help="npy of normalized NHWC float32 images for int8 "
                            "calibration; default: val batches, else "
                            "standard-normal images")
    extra_args, rest = extra.parse_known_args(argv)
    args = parse_args(rest)
    one_device_only(args, "export")
    device = resolve_device(args.device)
    cfg = get_default_config()
    update_config(cfg, args)
    logger, output_dir, _ = create_logger(cfg, args.cfg, "export")
    out_dir = extra_args.out or os.path.join(output_dir, "export")
    os.makedirs(out_dir, exist_ok=True)
    dtype_name = args.dtype or cfg.TRAIN.DTYPE
    dtype = torch.bfloat16 if dtype_name == "bfloat16" else torch.float32
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = bool(cfg.CUDNN.BENCHMARK)

    bottomup = cfg.MODEL.NAME == "pose_higher_hrnet"
    if extra_args.int8 and bottomup:
        raise ValueError("--int8 exports top-down models only; export a "
                         "bottom-up model without it (the JAX tool refuses "
                         "it too)")
    model = get_pose_net(cfg)
    load_test_model_file(model, cfg, output_dir, logger)
    model = model.to(device).eval()
    ds, flip_pairs = flip_pairs_of(cfg, logger)

    act_scales = None
    if extra_args.int8:
        set_compute_dtype(model, dtype, trainable=True)
        act_scales = int8_scales(model, cfg, ds, extra_args.calib, device,
                                 logger)
        with open(os.path.join(out_dir, INT8_SCALES), "w") as f:
            json.dump(act_scales, f, indent=0, sort_keys=True)
        model, w_scales = quant.prequantize_params(model, act_scales)
        logger.info(f"=> int8: {len(act_scales)} convs calibrated; "
                    f"{len(w_scales)} weights stored int8 (this final_state "
                    "is a serving artifact: it does not load into the f32 "
                    "model)")
    else:
        model = set_compute_dtype(model, dtype)

    infer = build_infer_fn(model, cfg, flip_pairs).eval()
    w, h = cfg.MODEL.IMAGE_SIZE
    b = extra_args.batch
    example = torch.zeros((b or 2, h, w, 3), device=device)
    dynamic = ({"image": {0: torch.export.Dim("batch", min=1, max=4096)}}
               if b == 0 else None)
    with torch.no_grad():
        program = torch.export.export(infer, (example,),
                                      dynamic_shapes=dynamic)
    program.example_inputs = None  # the archive would keep the zeros
    meta = {"device": device.type, "batch": b, "image_hw": [h, w],
            "model": cfg.MODEL.NAME, "int8": bool(extra_args.int8),
            "dtype": dtype_name,
            "outputs": list(BOTTOMUP_OUTPUTS) if bottomup else "preds"}
    path = os.path.join(out_dir, PROGRAM)
    torch.export.save(program, path, extra_files={META: json.dumps(meta)})
    batch_desc = "polymorphic" if b == 0 else str(b)
    logger.info(f"=> exported the inference program "
                f"({os.path.getsize(path) / 1e6:.1f} MB, batch {batch_desc}, "
                f"{w}x{h}, {device.type}) to {path}")
    wpath = export_final_state(out_dir, types.SimpleNamespace(model=model))
    logger.info(f"=> weights exported to {wpath}")

    # round trip: load the program back and run it
    loaded = torch.export.load(path).module()

    def shapes(out):
        if isinstance(out, dict):
            return {k: tuple(v.shape) for k, v in out.items()}
        return tuple(out.shape)

    with torch.no_grad():
        out = loaded(torch.zeros((b or 4, h, w, 3), device=device))
        logger.info(f"=> round trip OK: output {shapes(out)}")
        if b == 0:
            out7 = loaded(torch.zeros((7, h, w, 3), device=device))
            logger.info(f"=> polymorphic round trip OK at batch 7: "
                        f"{shapes(out7)}")
    return dict(path=path, program=program, meta=meta, out_dir=out_dir,
                final_state=wpath, model=model, act_scales=act_scales)


if __name__ == "__main__":
    main()
