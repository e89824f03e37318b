"""CLI argument surface of the port's entry points.

The flags of `tools/_parse.py` that the ported paths read, plus
`--device`: the entry points run on the card unless it says `cpu`.
`--kd_mseloss` names the MSE KD term the AdvMix steps always use, and
`--test_robust` / `--corruption_type` / `--severity` feed `update_config`.
The flags that the reference parses and never reads (`REFERENCE_ONLY`) are
accepted with one warning each that names the flag.

`--num_devices N` (JAX `tools/_parse.py:71`) runs N ranks, one per card:
the first N cards, 0 meaning all of them; with `--device cpu`, N ranks on
the CPU over gloo, 0 meaning 1. Asking for more cards than there are stops
the run: it never gives fewer ranks than asked. Under torchrun (RANK and
WORLD_SIZE set) the ranks are torchrun's, one per process, each on
`cuda:<LOCAL_RANK>` (on the CPU only with `--device cpu`). `ranks` puts a
tool's `main` in its rank, or launches the ranks.
"""

import argparse
import os
import sys
import warnings

import torch

from ..parallel import dist as pdist
from ..utils.device import resolve_device

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
    p.add_argument("--num_devices", type=int, default=0,
                   help="ranks, one per card: the first N cards (0: all); "
                        "with --device cpu, N ranks on the CPU (0: 1)")
    args = p.parse_args(argv)
    for flag in REFERENCE_ONLY:
        if hasattr(args, flag[2:]):
            warnings.warn(f"{flag} is accepted and ignored: the reference "
                          "parses it and reads it nowhere", stacklevel=2)
            delattr(args, flag[2:])
    return args


def _rank_devices(args) -> list:
    """The ranks' devices that `--num_devices` and `--device` ask for, from
    a process that is none of them."""
    n = int(args.num_devices)
    dev = resolve_device(args.device)  # without a card: raises
    if dev.type != "cuda":
        return [str(dev)] * max(n, 1)
    if dev.index is not None:
        if n > 1:
            raise SystemExit(f"--device {dev} names one card; --num_devices "
                             f"{n} takes the first {n}: give one or the "
                             "other")
        return [str(dev)]
    count = torch.cuda.device_count()
    if n > count:
        raise SystemExit(f"--num_devices {n} asks for more cards than the "
                         f"{count} this machine has")
    return [f"cuda:{i}" for i in range(n or count)]


def ranks(main, args, argv, *extra):
    """Where this process runs in the ranks that `--num_devices` asks for.

    Returns `(device, None)` when this process is a rank: one spawned by a
    launcher, one of torchrun's (it joins torchrun's group here, on
    `cuda:<LOCAL_RANK>`, or on the CPU only with `--device cpu`), or the
    only one. Else launches the ranks, each running `main(argv, *extra)`
    on the same command line, and returns `(None, rank 0's result)`."""
    n = int(args.num_devices)
    if n < 0:
        raise SystemExit(f"--num_devices {n}: give 0 (all) or a count")
    if pdist.world() > 1:
        return pdist.device(), None
    if pdist.torchrun_env():
        world = int(os.environ["WORLD_SIZE"])
        if n not in (0, world):
            raise SystemExit(f"--num_devices {n} under torchrun, whose "
                             f"WORLD_SIZE is {world}: give one or the other")
        pdist.init_process_group(devices=args.device)
        return pdist.device(), None
    devices = _rank_devices(args)
    if len(devices) == 1:
        return resolve_device(args.device), None
    return None, pdist.launch(main, devices,
                              sys.argv[1:] if argv is None else argv, *extra)


def one_device_only(args, tool: str) -> None:
    """Tools that run on one device refuse more ranks than one."""
    if args.num_devices > 1:
        raise SystemExit(f"{tool} runs on one device: --num_devices "
                         f"{args.num_devices} is not supported")
