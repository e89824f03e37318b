"""CLI argument surface of the port's entry points.

The flags of `tools/_parse.py` that the ported paths read, plus
`--device`: the entry points run on the card unless it says `cpu`. A flag
whose feature is not ported yet is parsed, and `reject_later_slices` stops
the run with an error that names what is missing; none is accepted and
ignored.
"""

import argparse


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

    # AdvMix training
    p.add_argument("--advmix", default=False, action="store_true")
    p.add_argument("--sample_times", type=int, default=1)
    p.add_argument("--adv_loss_weight", type=float, default=1)
    p.add_argument("--alpha", type=float, default=0.1)
    p.add_argument("--load_from_G", type=str, default="")
    p.add_argument("--load_from_D", type=str, default="")
    p.add_argument("--gen_input_chn", type=int, default=9)
    p.add_argument("--downsamples", type=int, default=6)

    # per-image random benchmark corruption of the training crops
    p.add_argument("--random_corruption", default=False, action="store_true")
    # train on the dataset and its stylized copy; --sp_style exempts the
    # stylized samples from AutoAugment and GridMask
    p.add_argument("--stylize_image", default=False, action="store_true")
    p.add_argument("--sp_style", type=float, default=0)

    p.add_argument("--dtype", type=str, default="",
                   help="override TRAIN.DTYPE (float32|bfloat16)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default: the CUDA device (raises "
                        "without one); 'cpu' runs on the CPU")
    return p.parse_args(argv)


def reject_later_slices(args, cfg) -> None:
    """Stop with an error for every option whose feature the port does not
    have yet."""
    later = []
    if cfg.TRAIN.INT8_TEACHER:
        later.append("TRAIN.INT8_TEACHER needs ops/quant.py: the int8 and "
                     "serving slice")
    if cfg.MODEL.NAME == "pose_higher_hrnet":
        later.append("MODEL.NAME pose_higher_hrnet is the bottom-up "
                     "HigherHRNet slice")
    if cfg.DATASET.DATASET in ("bottomup_coco", "ochuman"):
        later.append(f"DATASET.DATASET {cfg.DATASET.DATASET} is the "
                     "bottom-up HigherHRNet slice")
    if later:
        raise SystemExit("not ported yet: " + "; ".join(later))
