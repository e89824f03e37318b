"""Training entry point: standard top-down training and AdvMix.

    python -m advmix_tpu_torch.tools.train --cfg <yaml> [--advmix \
        --sample_times 3] [--random_corruption] [--device cpu] \
        [KEY VALUE ...]

Port of `tools/train.py` for the top-down branches: the model (and, under
--advmix, the teacher copy and the UNet generator, :64-69), datasets and
loaders, the optimizers with their per-epoch MultiStepLR (:184-186,
272-281), fine-tune loading (--load_from_D / --load_from_G), AUTO_RESUME
(:238-269), the epoch loop with a validation pass and a checkpoint after
every epoch (:283-328), and the final export of the weights (:331-337). It
runs on the CUDA device, and raises without one unless `--device cpu` is
given.
"""

from __future__ import annotations

import os
import pprint

import torch

from ..config import get_default_config, update_config
from ..data import CachedLoader, Loader
from ..data import build_dataset as default_build_dataset
from ..engine import state as state_lib
from ..engine import steps
from ..engine import trainer as trainer_lib
from ..engine.checkpoint import CheckpointManager, export_final_state
from ..engine.optim import epoch_lr_update
from ..models import get_generator, get_pose_net, he_reinit_convs, \
    load_generator_file, load_model_file, load_pretrained
from ..utils.device import resolve_device
from ..utils.logging import create_logger
from ._parse import parse_args, reject_later_slices


def main(argv=None, build_dataset=default_build_dataset):
    """Train as the arguments say. `build_dataset(cfg, is_train, image_set)`
    makes the datasets (the default reads cfg.DATASET). Returns a dict with
    the config, the state, the per-iteration metrics of the epochs that ran, the last
    validation's score, the output directory and the final state's path."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_default_config()
    update_config(cfg, args)
    reject_later_slices(args, cfg)

    logger, output_dir, _ = create_logger(cfg, args.cfg, "train")
    logger.info(pprint.pformat(vars(args)))
    dtype_name = args.dtype or cfg.TRAIN.DTYPE
    dtype = torch.bfloat16 if dtype_name == "bfloat16" else torch.float32
    logger.info(f"=> device {device}, compute dtype {dtype_name}")
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = bool(cfg.CUDNN.BENCHMARK)
    if dtype_name != cfg.TRAIN.DTYPE:
        cfg.defrost()
        cfg.TRAIN.DTYPE = dtype_name  # the preprocessor reads it
        cfg.freeze()

    model = get_pose_net(cfg)
    if dict(cfg.MODEL.EXTRA).get("HE_INIT"):
        he_reinit_convs(model, torch.Generator().manual_seed(42))
        logger.info("=> HE_INIT: conv kernels re-initialized (He)")
    if cfg.MODEL.INIT_WEIGHTS and os.path.isfile(cfg.MODEL.PRETRAINED):
        n = load_pretrained(model, cfg.MODEL.PRETRAINED,
                            dict(cfg.MODEL.EXTRA).get("PRETRAINED_LAYERS"))
        logger.info(f"=> loaded {n} keys of pretrained {cfg.MODEL.PRETRAINED}")
    if args.load_from_D:
        # after the config's PRETRAINED, so that the explicit warm start wins
        load_model_file(model, args.load_from_D)
        logger.info(f"=> loaded D from {args.load_from_D}")

    advmix = bool(args.advmix) and args.sample_times > 1
    if advmix:
        model_g = get_generator(args)
        if args.load_from_G:
            load_generator_file(model_g, args.load_from_G)
            logger.info(f"=> loaded G from {args.load_from_G}")
        # the teacher is a copy of D as loaded above
        state = state_lib.create_advmix_state(cfg, model, model_g, device,
                                              dtype)
        step_fn = steps.make_advmix_step(
            state, cfg, alpha=args.alpha,
            adv_loss_weight=args.adv_loss_weight, num_views=args.sample_times)
    else:
        state = state_lib.create_pose_state(cfg, model, device, dtype)
        step_fn = steps.make_train_step(state, cfg)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"=> {cfg.MODEL.NAME}: {n_params} parameters")

    train_dataset = build_dataset(cfg, True, None)
    # MINI_COCO debug mode validates on the train set (tools/train.py:127-134)
    valid_dataset = build_dataset(
        cfg, False, cfg.DATASET.TRAIN_SET if cfg.DATASET.MINI_COCO else None)
    device_warp = bool(cfg.DATASET.DEVICE_WARP)
    train_loader = Loader(train_dataset, cfg.TRAIN.BATCH_SIZE_PER_GPU,
                          shuffle=cfg.TRAIN.SHUFFLE, drop_last=True,
                          raw_mode=device_warp,
                          bucket_hw=tuple(cfg.DATASET.WARP_BUCKET))
    # every epoch's validation prepares the same batches: replay them from
    # host memory after the first epoch
    valid_loader = CachedLoader(Loader(valid_dataset,
                                       cfg.TEST.BATCH_SIZE_PER_GPU))
    if device_warp:
        logger.info("=> device-warp input pipeline (the host decodes only; "
                    f"bucket {tuple(cfg.DATASET.WARP_BUCKET)})")
    logger.info(f"=> {len(train_dataset)} train / {len(valid_dataset)} val "
                "samples")

    prep_train = trainer_lib.make_preprocessor(
        cfg, advmix=advmix, device=device, device_warp=device_warp,
        random_corruption=args.random_corruption)
    if args.random_corruption:
        logger.info("=> --random_corruption: a random benchmark corruption "
                    "per training image")
    prep_eval = trainer_lib.make_eval_preprocessor(cfg, device)
    eval_step = steps.make_eval_step(model, cfg, valid_dataset.flip_pairs)

    ckpt = CheckpointManager(output_dir)
    begin_epoch = cfg.TRAIN.BEGIN_EPOCH
    best_perf = -1.0
    if cfg.AUTO_RESUME:
        restored = ckpt.restore(state)
        if restored is not None:
            begin_epoch = int(restored["epoch"]) + 1
            best_perf = float(restored["perf"])
            logger.info(f"=> auto-resumed at epoch {begin_epoch}")

    generator = torch.Generator().manual_seed(1234 + begin_epoch)
    optimizers = ([state.optimizer_d, state.optimizer_g] if advmix
                  else [state.optimizer])
    history, perf = [], None
    for epoch in range(begin_epoch, cfg.TRAIN.END_EPOCH):
        for opt in optimizers:  # per-epoch MultiStepLR (tools/train.py:272-281)
            lr = epoch_lr_update(opt, cfg, epoch)
        logger.info(f"=> epoch {epoch} lr {lr:.6g}")
        train_loader.set_epoch(epoch)
        history.append(trainer_lib.train_epoch(
            cfg, step_fn, prep_train, train_loader, device, epoch, generator,
            advmix=advmix))

        model.eval()
        _, perf = trainer_lib.validate(cfg, eval_step, prep_eval,
                                       valid_dataset, valid_loader,
                                       output_dir, device)
        is_best = perf > best_perf
        best_perf = max(perf, best_perf)
        logger.info(f"=> saving checkpoint to {output_dir} (best: {is_best})")
        ckpt.save(epoch, state, perf, is_best)

    final = export_final_state(output_dir, state)
    logger.info(f"=> final state saved to {final}")
    return dict(cfg=cfg, state=state, history=history, perf=perf,
                begin_epoch=begin_epoch, output_dir=output_dir,
                final_state=final)


if __name__ == "__main__":
    main()
