"""Training entry point: standard and AdvMix training, top-down and
bottom-up.

    python -m advmix_tpu_torch.tools.train --cfg <yaml> [--advmix \
        --sample_times 3] [--random_corruption] [--stylize_image \
        [--sp_style 1]] [--device cpu] [KEY VALUE ...]

Port of `tools/train.py`: the model (and, under
--advmix, the teacher copy and the UNet generator, :64-69), datasets and
loaders, the optimizers with their per-epoch MultiStepLR (:184-186,
272-281), fine-tune loading (--load_from_D / --load_from_G), AUTO_RESUME
(:238-269), the epoch loop with a validation pass and a checkpoint after
every epoch (:283-328), and the final export of the weights (:331-337).
`--stylize_image` trains on the union of the dataset and its stylized copy
under `<dirname(ROOT)>/stylize_image_<DATASET>` (:145-163), and with it
`--sp_style` exempts the stylized samples from AutoAugment and GridMask;
DEBUG.DEBUG dumps image grids in training and validation (`utils/vis.py`).
TRAIN.INT8_TEACHER gives the top-down AdvMix step a W8A8 teacher
(`ops/quant.py`; :151-165, 270-290), calibrated on the first
TEST.INT8_CALIB_BATCHES train batches; a bottom-up config warns and
ignores it, as the JAX tool does.
MODEL.NAME pose_higher_hrnet trains bottom-up (:74,150-160,207-208,245,
297-301,349-363): the bottom-up steps of `engine/steps.py`, whole-image
samples warped on the host (DATASET.DEVICE_WARP does not apply), and the
bottom-up validation after every epoch.
It runs on the CUDA device, and raises without one unless `--device cpu`
is given. `--num_devices N` trains data-parallel on N ranks, one per card
(`tools/_parse.py`; JAX `tools/train.py:240-259`): each loads its shard of
every global batch of N * TRAIN.BATCH_SIZE_PER_GPU, the steps average
gradients and BN statistics over the ranks, validation gathers to rank 0,
and rank 0 writes the logs and checkpoints; `main` returns rank 0's
result, its tensors on the CPU.
"""

from __future__ import annotations

import os
import pprint

import torch

from ..config import get_default_config, update_config
from ..data import CachedLoader, ConcatDataset, Loader
from ..data import build_dataset as default_build_dataset
from ..data import build_stylized_dataset
from ..engine import state as state_lib
from ..engine import steps
from ..engine import trainer as trainer_lib
from ..engine.checkpoint import CheckpointManager, export_final_state
from ..engine.optim import epoch_lr_update
from ..models import get_generator, get_pose_net, he_reinit_convs, \
    load_generator_file, load_model_file, load_pretrained
from ..utils.logging import create_logger
from ..ops import quant
from ..parallel import dist as pdist
from ._parse import parse_args, ranks


def main(argv=None, build_dataset=default_build_dataset):
    """Train as the arguments say. `build_dataset(cfg, is_train, image_set)`
    makes the datasets (the default reads cfg.DATASET). Returns a dict with
    the config, the state, the per-iteration metrics of the epochs that ran, the last
    validation's score, the output directory and the final state's path."""
    args = parse_args(argv)
    device, launched = ranks(main, args, argv, build_dataset)
    if device is None:
        return launched
    group, world, rank = pdist.data_group(), pdist.world(), pdist.rank()
    cfg = get_default_config()
    update_config(cfg, args)
    if args.sp_style and not args.stylize_image:
        raise SystemExit("--sp_style exempts the stylized samples of "
                         "--stylize_image: give both")
    bottomup = cfg.MODEL.NAME == "pose_higher_hrnet"
    if bottomup:
        # the JAX package's bottom-up path ignores these; say so instead
        top_down_only = [name for name, on in (
            ("--random_corruption", args.random_corruption),
            ("--sp_style", args.sp_style),
            ("DEBUG.DEBUG", cfg.DEBUG.DEBUG)) if on]
        if top_down_only:
            raise SystemExit(f"{', '.join(top_down_only)}: top-down only; "
                             "the bottom-up path has no such option")

    logger, output_dir, _ = create_logger(cfg, args.cfg, "train",
                                          main=pdist.is_main())
    logger.info(pprint.pformat(vars(args)))
    dtype_name = args.dtype or cfg.TRAIN.DTYPE
    dtype = torch.bfloat16 if dtype_name == "bfloat16" else torch.float32
    logger.info(f"=> device {device}, {world} rank(s), compute dtype "
                f"{dtype_name}")
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = bool(cfg.CUDNN.BENCHMARK)
        # an f32 config's convolutions run in TF32 unless this is off
        logger.info(f"=> TF32: cuDNN convolutions "
                    f"{torch.backends.cudnn.allow_tf32}, matmuls "
                    f"{torch.backends.cuda.matmul.allow_tf32}")
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
    debug = bool(cfg.DEBUG.DEBUG)
    if advmix:
        model_g = get_generator(args)
        if args.load_from_G:
            load_generator_file(model_g, args.load_from_G)
            logger.info(f"=> loaded G from {args.load_from_G}")
        # the teacher is a copy of D as loaded above
        state = state_lib.create_advmix_state(cfg, model, model_g, device,
                                              dtype)
        for m in (state.model_d, state.model_g, state.teacher):
            pdist.broadcast_module_(m)
        if bottomup:
            if cfg.TRAIN.INT8_TEACHER:
                logger.warning("=> TRAIN.INT8_TEACHER ignored for bottom-up "
                               "configs, as the JAX package ignores it")
            step_fn = steps.make_bottomup_advmix_step(
                state, cfg, alpha=args.alpha,
                adv_loss_weight=args.adv_loss_weight,
                num_views=args.sample_times, group=group)
        else:
            # built once the train dataset exists: TRAIN.INT8_TEACHER
            # calibrates on its first batches
            step_fn = None
    else:
        state = state_lib.create_pose_state(cfg, model, device, dtype)
        pdist.broadcast_module_(state.model)
        step_fn = (steps.make_bottomup_step(state, cfg, group=group)
                   if bottomup else
                   steps.make_train_step(state, cfg, debug=debug, group=group))
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"=> {cfg.MODEL.NAME}: {n_params} parameters")

    train_dataset = build_dataset(cfg, True, None)
    if args.stylize_image:
        # union with the stylized copy (tools/train.py:145-163); the tags
        # feed the --sp_style exemption
        train_dataset = ConcatDataset(
            [train_dataset, build_stylized_dataset(cfg, True, build_dataset)],
            style_tags=[0.0, 1.0])
    # MINI_COCO debug mode validates on the train set (tools/train.py:127-134)
    valid_dataset = build_dataset(
        cfg, False, cfg.DATASET.TRAIN_SET if cfg.DATASET.MINI_COCO else None)
    # a bottom-up sample is the whole image, warped on the host
    device_warp = bool(cfg.DATASET.DEVICE_WARP) and not bottomup
    shards = dict(num_shards=world, shard_index=rank)
    train_loader = Loader(train_dataset, cfg.TRAIN.BATCH_SIZE_PER_GPU,
                          shuffle=cfg.TRAIN.SHUFFLE, drop_last=True,
                          raw_mode=device_warp,
                          bucket_hw=tuple(cfg.DATASET.WARP_BUCKET), **shards)
    # every epoch's validation prepares the same batches: replay them from
    # host memory after the first epoch
    valid_loader = CachedLoader(Loader(valid_dataset,
                                       cfg.TEST.BATCH_SIZE_PER_GPU, **shards))
    if device_warp:
        logger.info("=> device-warp input pipeline (the host decodes only; "
                    f"bucket {tuple(cfg.DATASET.WARP_BUCKET)})")
    logger.info(f"=> {len(train_dataset)} train / {len(valid_dataset)} val "
                "samples")

    if advmix and step_fn is None:
        if cfg.TRAIN.INT8_TEACHER:
            # the teacher is a copy of D as loaded: quantize D's f32 master
            # weights, calibrated on the first clean train crops (of rank
            # 0's shard; every rank quantizes with rank 0's scales)
            act_scales = None
            if pdist.is_main():
                state.teacher, act_scales = quant.int8_teacher_from_config(
                    dtype, state.model_d, device=device,
                    loader=Loader(train_dataset,
                                  cfg.TRAIN.BATCH_SIZE_PER_GPU,
                                  num_shards=world),
                    n_batches=cfg.TEST.INT8_CALIB_BATCHES,
                    margin=float(cfg.TEST.INT8_CALIB_MARGIN))
            if world > 1:
                act_scales = pdist.broadcast_from_main(act_scales)
                if not pdist.is_main():
                    state.teacher = quant.make_int8_teacher(state.model_d,
                                                            act_scales)
            logger.info(f"=> int8 teacher: {len(act_scales)} convs "
                        "calibrated")
        step_fn = steps.make_advmix_step(
            state, cfg, alpha=args.alpha,
            adv_loss_weight=args.adv_loss_weight,
            num_views=args.sample_times, debug=debug, group=group)

    if bottomup:
        prep_train = trainer_lib.make_bottomup_preprocessor(cfg, advmix,
                                                            device)
        eval_step = steps.make_bottomup_eval_step(
            model, cfg, valid_dataset.flip_pairs,
            scales=tuple(cfg.TEST.SCALE_FACTOR))
    else:
        prep_train = trainer_lib.make_preprocessor(
            cfg, advmix=advmix, device=device, device_warp=device_warp,
            random_corruption=args.random_corruption,
            sp_style=bool(args.sp_style and args.stylize_image))
        prep_eval = trainer_lib.make_eval_preprocessor(cfg, device)
        eval_step = steps.make_eval_step(model, cfg, valid_dataset.flip_pairs,
                                         debug=debug, group=group)
    if args.random_corruption:
        logger.info("=> --random_corruption: a random benchmark corruption "
                    "per training image")
    debug_dir = trainer_lib.output_dir_of(cfg) if debug else None

    ckpt = CheckpointManager(output_dir)
    begin_epoch = cfg.TRAIN.BEGIN_EPOCH
    best_perf = -1.0
    if cfg.AUTO_RESUME:
        restored = ckpt.restore(state)
        if restored is not None:
            begin_epoch = int(restored["epoch"]) + 1
            best_perf = float(restored["perf"])
            logger.info(f"=> auto-resumed at epoch {begin_epoch}")

    generator = trainer_lib.rank_generator(1234 + begin_epoch)
    optimizers = ([state.optimizer_d, state.optimizer_g] if advmix
                  else [state.optimizer])
    history, perf = [], None
    for epoch in range(begin_epoch, cfg.TRAIN.END_EPOCH):
        for opt in optimizers:  # per-epoch MultiStepLR (tools/train.py:272-281)
            lr = epoch_lr_update(opt, cfg, epoch)
        logger.info(f"=> epoch {epoch} lr {lr:.6g}")
        train_loader.set_epoch(epoch)
        train = (trainer_lib.train_epoch_bottomup if bottomup
                 else trainer_lib.train_epoch)
        history.append(train(cfg, step_fn, prep_train, train_loader, device,
                             epoch, generator, advmix=advmix))

        model.eval()
        if bottomup:
            _, perf = trainer_lib.validate_bottomup(
                cfg, eval_step, valid_dataset, valid_loader, output_dir,
                device, group=group)
        else:
            _, perf = trainer_lib.validate(cfg, eval_step, prep_eval,
                                           valid_dataset, valid_loader,
                                           output_dir, device,
                                           debug_out_dir=debug_dir,
                                           group=group)
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
