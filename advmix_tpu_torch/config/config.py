"""Configuration system.

The port's own copy of `advmix_tpu/config/config.py`: the same tree, the
same defaults and the same merge rules, so every YAML in `experiments/`
loads unchanged and both packages read identical config trees. Keys that
only shape the JAX program (`MODEL.EXTRA.USE_SCAN`, `MODEL.EXTRA.REMAT`,
`GPUS`) are accepted and ignored here; `TRAIN.CROSS_REPLICA_BN` makes the
train steps' BatchNorm statistics cross-replica when there are several
ranks (`models/layers.cross_replica_bn`). The port alone reads
`TRAIN.OPTIMIZER: adamw` (decoupled weight decay TRAIN.WD) and the HRFormer
keys of the free-form MODEL.EXTRA (`STAGE1.NUM_BLOCKS`, each stage's
`NUM_HEADS`, `WINDOW_SIZES`, `MLP_RATIOS`, and `DROP_PATH_RATE`;
`models/pose_hrformer.py`); the defaults stay the JAX package's.
"""

from __future__ import annotations

import ast
import copy
import os
from typing import Any, Iterable

import yaml


class ConfigNode(dict):
    """Dict with attribute access, hierarchical merge, and freezing."""

    def __init__(self, init: dict | None = None):
        super().__init__()
        object.__setattr__(self, "_frozen", False)
        if init:
            for k, v in init.items():
                self[k] = ConfigNode(v) if isinstance(v, dict) else v

    # -- attribute access ---------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, "_frozen"):
            raise AttributeError(f"ConfigNode is frozen; cannot set {name}")
        self[name] = ConfigNode(value) if isinstance(value, dict) else value

    def __setitem__(self, key, value):
        if object.__getattribute__(self, "_frozen"):
            raise AttributeError(f"ConfigNode is frozen; cannot set {key}")
        super().__setitem__(key, value)

    def __reduce__(self):
        # rebuilt through __init__, so a pickled config (a rank's result)
        # loads back, frozen as it was
        return (_unpickle_node, (dict(self), self._frozen))

    # -- lifecycle ----------------------------------------------------------
    def freeze(self) -> None:
        object.__setattr__(self, "_frozen", True)
        for v in self.values():
            if isinstance(v, ConfigNode):
                v.freeze()

    def defrost(self) -> None:
        object.__setattr__(self, "_frozen", False)
        for v in self.values():
            if isinstance(v, ConfigNode):
                v.defrost()

    def clone(self) -> "ConfigNode":
        out = ConfigNode()
        for k, v in self.items():
            out[k] = v.clone() if isinstance(v, ConfigNode) else copy.deepcopy(v)
        return out

    # -- merging ------------------------------------------------------------
    def merge_from_dict(self, other: dict) -> None:
        for k, v in other.items():
            if isinstance(v, dict):
                if k not in self or not isinstance(self[k], ConfigNode):
                    self[k] = ConfigNode()
                self[k].merge_from_dict(v)
            else:
                self[k] = _coerce(self.get(k), v)

    def merge_from_file(self, path: str) -> None:
        with open(path) as f:
            data = yaml.safe_load(f) or {}
        self.merge_from_dict(data)

    def merge_from_list(self, opts: Iterable[str]) -> None:
        opts = list(opts or [])
        assert len(opts) % 2 == 0, f"odd number of override tokens: {opts}"
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for j, p in enumerate(parts[:-1]):
                if p not in node:
                    # yacs raises on unknown keys (silent typos are worse);
                    # free-form subtrees (MODEL.EXTRA) may grow new children
                    if p == "EXTRA" or "EXTRA" in parts[:j]:
                        node[p] = ConfigNode()
                    else:
                        raise KeyError(f"non-existent config key: {key}")
                node = node[p]
            if parts[-1] not in node and "EXTRA" not in parts[:-1]:
                raise KeyError(f"non-existent config key: {key}")
            try:
                value = ast.literal_eval(value)
            except (ValueError, SyntaxError):
                pass
            node[parts[-1]] = _coerce(node.get(parts[-1]), value)

    def to_dict(self) -> dict:
        return {
            k: (v.to_dict() if isinstance(v, ConfigNode) else v)
            for k, v in self.items()
        }


def _unpickle_node(items: dict, frozen: bool) -> ConfigNode:
    node = ConfigNode(items)
    if frozen:
        node.freeze()
    return node


def _coerce(old: Any, new: Any) -> Any:
    """Coerce a new value toward the old value's type (yacs-like leniency)."""
    if old is None:
        return new
    if isinstance(old, tuple) and isinstance(new, list):
        return tuple(new)
    if isinstance(old, list) and isinstance(new, tuple):
        return list(new)
    if isinstance(old, float) and isinstance(new, int):
        return float(new)
    return new


def get_default_config() -> ConfigNode:
    """Default config tree, key-compatible with AdvMix lib/config/default.py."""
    c = ConfigNode()
    c.OUTPUT_DIR = ""
    c.LOG_DIR = ""
    c.DATA_DIR = ""
    c.GPUS = (0,)  # kept for YAML compat; --num_devices picks the cards
    c.WORKERS = 4
    c.PRINT_FREQ = 20
    c.AUTO_RESUME = False
    c.PIN_MEMORY = True
    c.RANK = 0

    # Reference CUDNN block; the validate entry point applies BENCHMARK.
    c.CUDNN = ConfigNode()
    c.CUDNN.BENCHMARK = True
    c.CUDNN.DETERMINISTIC = False
    c.CUDNN.ENABLED = True

    c.MODEL = ConfigNode()
    c.MODEL.NAME = "pose_hrnet"
    c.MODEL.INIT_WEIGHTS = True
    c.MODEL.PRETRAINED = ""
    c.MODEL.NUM_JOINTS = 17
    c.MODEL.TAG_PER_JOINT = True
    c.MODEL.TARGET_TYPE = "gaussian"
    c.MODEL.IMAGE_SIZE = [256, 256]  # [w, h]
    c.MODEL.HEATMAP_SIZE = [64, 64]  # [w, h]
    c.MODEL.SIGMA = 2
    c.MODEL.EXTRA = ConfigNode()

    c.LOSS = ConfigNode()
    c.LOSS.USE_OHKM = False
    c.LOSS.TOPK = 8
    c.LOSS.USE_TARGET_WEIGHT = True
    c.LOSS.USE_DIFFERENT_JOINTS_WEIGHT = False
    # Criterion quirk preserved from the reference (lib/core/loss.py:16-21):
    # the default criterion is SmoothL1 (smooth_L1 flag False selects
    # SmoothL1Loss); set SMOOTH_L1: true to switch to plain MSE.
    c.LOSS.SMOOTH_L1 = False

    c.DATASET = ConfigNode()
    c.DATASET.ROOT = ""
    c.DATASET.ROOT_C = ""
    c.DATASET.DATASET = "mpii"
    c.DATASET.TRAIN_SET = "train"
    c.DATASET.TEST_SET = "valid"
    c.DATASET.DATA_FORMAT = "jpg"
    c.DATASET.HYBRID_JOINTS_TYPE = ""
    c.DATASET.SELECT_DATA = False
    c.DATASET.FLIP = True
    c.DATASET.SCALE_FACTOR = 0.25
    c.DATASET.ROT_FACTOR = 30
    c.DATASET.PROB_HALF_BODY = 0.0
    c.DATASET.NUM_JOINTS_HALF_BODY = 8
    c.DATASET.COLOR_RGB = False
    c.DATASET.MINI_COCO = False
    # TPU-native extension: host does decode only; the crop warp runs
    # batched on device (Loader raw_mode + ops/transforms.warp_affine).
    # WARP_BUCKET (h, w) must cover the dataset's largest image.
    c.DATASET.DEVICE_WARP = False
    # size of the synthetic marker dataset (tests / robustness demo)
    c.DATASET.SYNTH_LENGTH = 64
    c.DATASET.WARP_BUCKET = [640, 640]
    c.DATASET.VAL_FG = False
    c.DATASET.VAL_MASK = False
    c.DATASET.VAL_PARSING = False

    c.TRAIN = ConfigNode()
    c.TRAIN.LR_FACTOR = 0.1
    c.TRAIN.LR_STEP = [90, 110]
    c.TRAIN.LR = 0.001
    c.TRAIN.OPTIMIZER = "adam"  # sgd | adam | adamw (the port)
    c.TRAIN.MOMENTUM = 0.9
    c.TRAIN.WD = 0.0001
    c.TRAIN.NESTEROV = False
    c.TRAIN.GAMMA1 = 0.99
    c.TRAIN.GAMMA2 = 0.0
    c.TRAIN.BEGIN_EPOCH = 0
    c.TRAIN.END_EPOCH = 140
    c.TRAIN.RESUME = False
    c.TRAIN.CHECKPOINT = ""
    c.TRAIN.BATCH_SIZE_PER_GPU = 32
    c.TRAIN.SHUFFLE = True
    # TPU-native extensions (absent in the reference):
    c.TRAIN.DTYPE = "float32"  # compute dtype: float32 | bfloat16
    c.TRAIN.CROSS_REPLICA_BN = False  # per-replica BN matches DataParallel
    # int8 (W8A8) TEACHER forward inside the AdvMix step: the teacher is
    # frozen inference, so it can run quantized like the serving path
    # (ops/quant.py), with int8-rounded KD targets. Opt-in; calibrated on
    # the first TEST.INT8_CALIB_BATCHES train batches. Read by the top-down
    # step (tools/train.py, tools/bench.py --int8_teacher); a bottom-up
    # config warns and ignores it, as the JAX package does.
    c.TRAIN.INT8_TEACHER = False

    c.TEST = ConfigNode()
    c.TEST.BATCH_SIZE_PER_GPU = 32
    c.TEST.FLIP_TEST = False
    c.TEST.POST_PROCESS = False
    c.TEST.SHIFT_HEATMAP = False
    c.TEST.USE_GT_BBOX = False
    c.TEST.TEST_ROBUST = False
    c.TEST.CORRUPTION_TYPE = ""
    c.TEST.SEVERITY = 0
    c.TEST.IMAGE_THRE = 0.1
    c.TEST.NMS_THRE = 0.6
    c.TEST.SOFT_NMS = False
    c.TEST.OKS_THRE = 0.5
    c.TEST.IN_VIS_THRE = 0.0
    c.TEST.COCO_BBOX_FILE = ""
    c.TEST.BBOX_THRE = 1.0
    c.TEST.MODEL_FILE = ""
    c.TEST.MASK_FILE = ""
    c.TEST.SOFT_ARGMAX = False
    c.TEST.BIAS = 0.0
    # W8A8 int8 eval (ops/quant.py, tools/test_corruption.py): the
    # activation scales are calibrated on the first N clean val batches.
    c.TEST.INT8 = False
    c.TEST.INT8_CALIB_BATCHES = 2
    # safety margin on the calibrated activation scales: corruption sweeps
    # calibrate on CLEAN batches, and heavy brightness/contrast severities
    # can push conv inputs past the clean range — >1 trades a little
    # rounding precision for saturation headroom (ADVICE r3 #1)
    c.TEST.INT8_CALIB_MARGIN = 1.2
    # bottom-up multi-scale test protocol (published HigherHRNet option):
    # e.g. [0.5, 1, 2] resizes the input per scale on device, averages the
    # per-scale flip-averaged heatmaps at the scale-1 resolution (tags stay
    # scale-1). [1] = single-scale (default).
    c.TEST.SCALE_FACTOR = [1]

    c.DEBUG = ConfigNode()
    c.DEBUG.DEBUG = False
    c.DEBUG.SAVE_BATCH_IMAGES_GT = False
    c.DEBUG.SAVE_BATCH_IMAGES_PRED = False
    c.DEBUG.SAVE_HEATMAPS_GT = False
    c.DEBUG.SAVE_HEATMAPS_PRED = False

    return c


def update_config(cfg: ConfigNode, args) -> None:
    """Merge YAML + CLI opts into cfg and resolve paths.

    Mirrors the reference `update_config` (lib/config/default.py:143-184),
    including ROOT_C derivation (`data/coco-C` / `data/mpii-C`).
    """
    cfg.defrost()
    if getattr(args, "cfg", None):
        cfg.merge_from_file(args.cfg)
    cfg.merge_from_list(getattr(args, "opts", []) or [])

    if getattr(args, "modelDir", None):
        cfg.OUTPUT_DIR = args.modelDir
    if getattr(args, "logDir", None):
        cfg.LOG_DIR = args.logDir
    if getattr(args, "dataDir", None):
        cfg.DATA_DIR = args.dataDir
    if getattr(args, "corruption_type", None):
        cfg.TEST.CORRUPTION_TYPE = args.corruption_type
    if hasattr(args, "severity"):
        cfg.TEST.SEVERITY = args.severity
    if hasattr(args, "test_robust"):
        cfg.TEST.TEST_ROBUST = args.test_robust

    cfg.DATASET.ROOT = os.path.join(cfg.DATA_DIR, cfg.DATASET.ROOT)
    if cfg.DATASET.DATASET == "coco":
        cfg.DATASET.ROOT_C = "data/coco-C"
    else:
        cfg.DATASET.ROOT_C = "data/mpii-C"
    cfg.DATASET.ROOT_C = os.path.join(cfg.DATA_DIR, cfg.DATASET.ROOT_C)
    cfg.MODEL.PRETRAINED = os.path.join(cfg.DATA_DIR, cfg.MODEL.PRETRAINED)
    if cfg.TEST.MODEL_FILE:
        cfg.TEST.MODEL_FILE = os.path.join(cfg.DATA_DIR, cfg.TEST.MODEL_FILE)
    cfg.freeze()


def load_config(path: str | None = None, opts: Iterable[str] | None = None) -> ConfigNode:
    """Convenience: defaults + optional YAML + optional opts, frozen."""
    cfg = get_default_config()
    if path:
        cfg.merge_from_file(path)
    if opts:
        cfg.merge_from_list(opts)
    cfg.freeze()
    return cfg
