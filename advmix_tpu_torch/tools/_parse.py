"""CLI argument surface of the port's entry points.

The flags of `tools/_parse.py` that the ported paths read, plus
`--device`: the entry points run on the card unless it says `cpu`.
`--kd_mseloss` names the MSE KD term the AdvMix steps always use, and
`--test_robust` / `--corruption_type` / `--severity` feed `update_config`.
The flags that the reference parses and never reads (`REFERENCE_ONLY`) are
accepted with one warning each that names the flag. A feature that is not
ported yet is stopped by `reject_later_slices` with an error that names
what is missing; none is accepted and ignored.
"""

import argparse
import warnings

# parsed by the reference (tools/_init_parse.py) and read nowhere in it:
# flag -> argparse keywords
REFERENCE_ONLY = {
    "--kd_klloss": dict(action="store_true"),
    "--combine_prob": dict(type=float),
    "--perturb_joint": dict(type=float),
    "--perturb_range": dict(type=int),
    "--joints_num": dict(type=int),
    "--prevModelDir": dict(type=str),
    "--save_suffix": dict(type=str),
    "--load_json_file": dict(type=str),
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Train or evaluate a keypoint network (PyTorch/CUDA)")
    p.add_argument("--cfg", help="experiment configure file name",
                   required=True, type=str)
    p.add_argument("opts", help="Modify config options from the command line",
                   default=None, nargs=argparse.REMAINDER)
    p.add_argument("--modelDir", type=str, default="")
    p.add_argument("--logDir", type=str, default="")
    p.add_argument("--dataDir", type=str, default="")
    p.add_argument("--exp_id", type=str, default="")

    # robustness testing (read by config.update_config)
    p.add_argument("--test_robust", default=False, action="store_true")
    p.add_argument("--corruption_type", type=str, default="")
    p.add_argument("--severity", type=int, default=0)

    # AdvMix training
    p.add_argument("--advmix", default=False, action="store_true")
    p.add_argument("--sample_times", type=int, default=1)
    p.add_argument("--adv_loss_weight", type=float, default=1)
    p.add_argument("--alpha", type=float, default=0.1)
    p.add_argument("--load_from_G", type=str, default="")
    p.add_argument("--load_from_D", type=str, default="")
    p.add_argument("--gen_input_chn", type=int, default=9)
    p.add_argument("--downsamples", type=int, default=6)
    # the KD term of the AdvMix steps is always the MSE one
    p.add_argument("--kd_mseloss", default=False, action="store_true")

    # per-image random benchmark corruption of the training crops
    p.add_argument("--random_corruption", default=False, action="store_true")
    # train on the dataset and its stylized copy; --sp_style exempts the
    # stylized samples from AutoAugment and GridMask
    p.add_argument("--stylize_image", default=False, action="store_true")
    p.add_argument("--sp_style", type=float, default=0)

    # absent from the namespace unless given, so a warning names exactly
    # the flags on the command line
    for flag, kw in REFERENCE_ONLY.items():
        p.add_argument(flag, default=argparse.SUPPRESS, **kw)

    p.add_argument("--dtype", type=str, default="",
                   help="override TRAIN.DTYPE (float32|bfloat16)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default: the CUDA device (raises "
                        "without one); 'cpu' runs on the CPU")
    args = p.parse_args(argv)
    for flag in REFERENCE_ONLY:
        if hasattr(args, flag[2:]):
            warnings.warn(f"{flag} is accepted and ignored: the reference "
                          "parses it and reads it nowhere", stacklevel=2)
            delattr(args, flag[2:])
    return args


def reject_later_slices(args, cfg) -> None:
    """Stop with an error for every option whose feature the port does not
    have yet."""
    if cfg.TRAIN.INT8_TEACHER:
        raise SystemExit("not ported yet: TRAIN.INT8_TEACHER needs "
                         "ops/quant.py: the int8 and serving slice")
