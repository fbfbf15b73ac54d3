"""Pretraining entry point of the port (CLI-compatible with the JAX package's
``cp2_tpu/train/pretrain.py`` and the reference's main.py).

Three raw-frame host streams (foreground, with SAM region maps when the
mapping type needs them, and two backgrounds) are decoded on the host,
pinned and copied to the card on a copy stream a batch ahead; each step
augments the uint8 frames on the card and runs the step of the
``--pretrain_type`` (CP2, PROPOSED, MOCO, BYOL, DENSECL, PROPOSED_V2; the
CP2/PROPOSED dense loss on the hand-written kernel where
``ssl.objectives.uses_dense_kernel`` says), per epoch, with cosine LR,
metrics, checkpoints and resume.

Run: ``python -m cp2_tpu_torch.train.pretrain --run_id r0 --log_dir
/tmp/logs --data_dirs <dir> [--pretrain_type CP2] ...``

It runs on the card; ``main(args, device="cpu")`` runs it on the CPU, as
the tests do.  Ported so far: every pretrain type on one process, with
``--imagenet_checkpoint`` (a torchvision-layout ResNet grafted into both
encoders); more than one process raises ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from cp2_tpu_torch.augment import AugmentConfig, pretrain_batch_augment
from cp2_tpu_torch.checkpoint import (
    gc_checkpoints,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
    wait_for_checkpoints,
)
from cp2_tpu_torch.checkpoint.io import is_checkpoint
from cp2_tpu_torch.ssl.train_step import (
    backbone_output_stride_of,
    cosine_lr_schedule,
    dense_output_stride_of,
    epoch_scalar_names,
    make_optimizer,
    make_pretrain_step,
)
from cp2_tpu_torch.types import (
    BackboneType,
    DatasetType,
    MappingType,
    NegativeType,
    PretrainType,
)

def get_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Copy-paste contrastive pretraining on an NVIDIA card"
    )
    # fmt: off
    parser.add_argument('--config', help='path to model configuration file')
    parser.add_argument('--run_id', required=True, type=str)
    parser.add_argument('--tags', nargs='+', default=[])
    parser.add_argument('--offline_wandb', action='store_true')
    parser.add_argument('--use_wandb', action='store_true')
    parser.add_argument('--debug', action='store_true')

    parser.add_argument('--pretrain_from_scratch', action='store_true')
    parser.add_argument('--use_predictor', action='store_true')
    parser.add_argument('--use_avgpool_global', action='store_true')
    parser.add_argument('--use_symmetrical_loss', action='store_true')
    parser.add_argument('--lmbd_coordinate', default=0, type=float)

    parser.add_argument('--log_dir', type=str, required=True)
    parser.add_argument('--wandb_project', type=str, default='ssl-pretraining')
    parser.add_argument('--wandb_team', type=str, default=None)

    parser.add_argument('--data_dirs', metavar='DIR', nargs='+', required=True)
    parser.add_argument('--directory_type', type=str,
                        choices=[x.name for x in DatasetType],
                        default=DatasetType.FILENAME.name)

    parser.add_argument('--backbone_type', type=str,
                        choices=[x.name for x in BackboneType],
                        default=BackboneType.DEEPLABV3.name)
    parser.add_argument('--pretrain_type', type=str,
                        choices=[x.name for x in PretrainType],
                        default=PretrainType.CP2.name)
    parser.add_argument('--mapping_type', type=str,
                        choices=[x.name for x in MappingType],
                        default=MappingType.CP2.name)
    parser.add_argument('--negative_type', type=str,
                        choices=[x.name for x in NegativeType],
                        default=NegativeType.NONE.name)
    parser.add_argument('--negative_scale', type=float, default=2)
    parser.add_argument('--num-workers', default=4, type=int)

    parser.add_argument('--lmbd_cp2_dense_loss', default=0.2, type=float)
    parser.add_argument('--lmbd_region_corr_weight', default=1, type=float)
    parser.add_argument('--lmbd_pixel_corr_weight', default=1, type=float)
    parser.add_argument('--lmbd_not_corr_weight', default=1, type=float)
    parser.add_argument('--pixel_ids_stride', default=1, type=int)
    parser.add_argument('--unet_truncated_dec_blocks', default=2, type=int)
    parser.add_argument('--same_foreground', action='store_true')
    parser.add_argument('--cap_queue', action='store_true')
    parser.add_argument('--include_background', action='store_true')

    parser.add_argument('--dense_logits_temp', default=1, type=float)
    parser.add_argument('--instance_logits_temp', default=0.2, type=float)

    parser.add_argument('--lemon_data', action='store_true')
    parser.add_argument('--img_height', default=224, type=int)
    parser.add_argument('--img_width', default=224, type=int)
    parser.add_argument('--foreground_min', default=0.5, type=float)
    parser.add_argument('--foreground_max', default=0.8, type=float)

    parser.add_argument('--epochs', default=200, type=int)
    parser.add_argument('--max_steps', default=np.inf, type=float)
    parser.add_argument('--start-epoch', default=0, type=int, dest='start_epoch')
    parser.add_argument('-b', '--batch-size', default=256, type=int, dest='batch_size')
    parser.add_argument('--lr', '--learning-rate', default=0.03, type=float, dest='lr')
    parser.add_argument('--remove_lr_scheduler', action='store_true')
    parser.add_argument('--momentum', default=0.9, type=float)
    parser.add_argument('--optim', default='sgd')
    parser.add_argument('--wd', '--weight-decay', default=1e-4, type=float,
                        dest='weight_decay')
    parser.add_argument('-p', '--print-freq', default=10, type=int, dest='print_freq')
    parser.add_argument('--scalar-freq', default=100, type=int, dest='scalar_freq')
    parser.add_argument('--visual-freq', default=1, type=int, dest='visual_freq',
                        help='epochs between visual artifacts (IoU histograms, '
                             'similarity heatmaps, example grids); 0 disables')
    parser.add_argument('--ckpt-freq', default=100, type=int, dest='ckpt_freq')
    parser.add_argument('--keep-ckpts', default=0, type=int, dest='keep_ckpts',
                        help='garbage-collect all but the newest N step '
                             'checkpoints (0 = keep all, as the reference does)')
    parser.add_argument('--async-ckpt', action='store_true', dest='async_ckpt',
                        help='copy the state to the host and write checkpoints '
                             'on a thread (training continues during the write)')
    parser.add_argument('--resume', default='', type=str)
    parser.add_argument('--seed', default=0, type=int)
    parser.add_argument('--metrics_level', default=1, type=int,
                        help='0=loss only, 1=reference scalar families')
    parser.add_argument('--steps-per-call', default=1, type=int,
                        dest='steps_per_call',
                        help='accepted for the JAX CLI\'s command lines: there '
                             'it chains K quiet steps into one lax.scan '
                             'dispatch; PyTorch has no such dispatch, so quiet '
                             'steps run one after another whatever K is, and '
                             'max_steps is met exactly')
    parser.add_argument('--prefetch_depth', default=2, type=int,
                        help='device-resident batches staged ahead by a '
                             'background thread (overlaps the host-to-device '
                             'copy of batch i+1 with step i); 0 copies inline')
    parser.add_argument('--imagenet_checkpoint', default='', type=str,
                        help='local torchvision resnet50 checkpoint for ImageNet init')
    parser.add_argument('--bf16', action='store_true', default=True)
    parser.add_argument('--no-bf16', dest='bf16', action='store_false')
    parser.add_argument('--native_loader', action='store_true', default=True,
                        help='use the C++ decode worker pool when available')
    parser.add_argument('--no-native_loader', dest='native_loader',
                        action='store_false')
    parser.add_argument('--raw_cache_dir', type=str, default=None,
                        help='directory for the native raw-frame cache: '
                             'decode+resize runs once, later epochs mmap '
                             '(invalidated when source files change)')
    # fmt: on

    args = parser.parse_args(argv)
    args.directory_type = DatasetType[args.directory_type]
    args.pretrain_type = PretrainType[args.pretrain_type]
    args.backbone_type = BackboneType[args.backbone_type]
    args.mapping_type = MappingType[args.mapping_type]
    args.negative_type = NegativeType[args.negative_type]

    if args.lemon_data:
        args.directory_type = DatasetType.CSV
        args.img_height = 512
        args.img_width = 512
    if args.debug:
        # reference --debug (main.py:47,724-729): an in-process smoke run at
        # batch 8, bounded to a handful of steps so one invocation runs the
        # whole loop (build, train steps, checkpoint) and exits
        args.batch_size = 8
        args.epochs = min(args.epochs, 1)
        args.max_steps = min(args.max_steps, 3)
        args.scalar_freq = 1
    return args


def hparams_from_args(args, dataset_size: int):
    """CLI flags → validated SSLHyperParams (reference main.py:390-433)."""
    from cp2_tpu_torch.ssl import SSLHyperParams

    return SSLHyperParams.for_variant(
        args.pretrain_type,
        dataset_size=dataset_size,
        cap_queue=args.cap_queue,
        backbone_type=args.backbone_type,
        mapping_type=args.mapping_type,
        negative_type=args.negative_type,
        negative_scale=args.negative_scale,
        include_background=args.include_background,
        lmbd_cp2_dense_loss=args.lmbd_cp2_dense_loss,
        lmbd_pixel_corr_weight=args.lmbd_pixel_corr_weight,
        lmbd_region_corr_weight=args.lmbd_region_corr_weight,
        lmbd_not_corr_weight=args.lmbd_not_corr_weight,
        lmbd_coordinate=args.lmbd_coordinate,
        dense_logits_temp=args.dense_logits_temp,
        instance_logits_temp=args.instance_logits_temp,
        pixel_ids_stride=args.pixel_ids_stride,
        unet_truncated_dec_blocks=args.unet_truncated_dec_blocks,
        use_predictor=args.use_predictor,
        use_avgpool_global=args.use_avgpool_global,
        use_symmetrical_loss=args.use_symmetrical_loss,
    )


def check_ported(args) -> None:
    """Raise ``NotImplementedError`` for what the port does not run yet."""
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError("more than one process is not ported yet")


def main(args, device="cuda"):
    """Train as the flags say, on ``device``; returns the final state.

    The default device is the card: with none present this raises, it
    never carries on on the CPU.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    check_ported(args)

    import cp2_tpu_torch
    from cp2_tpu_torch.config import Config
    from cp2_tpu_torch.data import HostDataLoader, PretrainDataSource, get_pretrain_files
    from cp2_tpu_torch.data.datasets import region_mask_path
    from cp2_tpu_torch.data.prefetch import DevicePrefetcher, HostToDevice
    from cp2_tpu_torch.ssl import SSLEncoder, create_pretrain_state
    from cp2_tpu_torch.utils import (
        AverageMeter,
        MetricLogger,
        ProgressMeter,
        seed_everything,
        setup_logger,
    )
    from cp2_tpu_torch.utils.logging import collect_env

    seed = seed_everything(args.seed)
    run_dir = os.path.join(args.log_dir, args.run_id)
    os.makedirs(run_dir, exist_ok=True)
    logger = setup_logger("pretrain", run_dir)
    metrics_sink = MetricLogger(
        args.log_dir, args.run_id,
        use_wandb=args.use_wandb, wandb_project=args.wandb_project,
        wandb_team=args.wandb_team, offline=args.offline_wandb,
        config={"hyper-parameters": vars(args), "env": collect_env()},
        tags=["pretrain"] + args.tags,
    )

    config_path = args.config or os.path.join(
        os.path.dirname(cp2_tpu_torch.__file__), "configs", "config_pretrain.py"
    )
    model_cfg = dict(Config.fromfile(config_path).model)

    files = get_pretrain_files(args.data_dirs, args.directory_type, "train")
    logger.info(f"dataset size: {len(files)}")
    hp = hparams_from_args(args, dataset_size=len(files))

    model = SSLEncoder(
        model_cfg,
        pretrain_type=args.pretrain_type,
        backbone_type=args.backbone_type,
        dim=hp.dim,
        unet_truncated_dec_blocks=hp.unet_truncated_dec_blocks,
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        img_hw=(args.img_height, args.img_width),
    )

    hw = (args.img_height, args.img_width)
    # SAM region maps ride the foreground stream when the mapping reads
    # region ids (reference loader.py:75-83)
    need_region = hp.mapping_type in (MappingType.REGION_ID, MappingType.PIXEL_REGION_ID)
    base_hw = (args.img_height + 32, args.img_width + 32)
    if args.raw_cache_dir:
        os.makedirs(args.raw_cache_dir, exist_ok=True)

    def make_loader(loader_seed, with_region=False):
        # the native C++ decode pool when its build works here, else the
        # Python loader (PIL), said once in the log
        if args.native_loader:
            from cp2_tpu_torch.native import (
                NativePairLoader,
                NativePretrainLoader,
                build_error,
                default_cache_path,
                native_available,
            )

            if native_available():
                threads = max(args.num_workers, 1)
                if with_region:
                    pairs = [(f, region_mask_path(f)) for f in files]
                    cache = default_cache_path(
                        args.raw_cache_dir, [p for pr in pairs for p in pr], base_hw,
                        "region") if args.raw_cache_dir else None
                    return NativePairLoader(pairs, args.batch_size, base_hw,
                                            mode="region", threads=threads,
                                            seed=loader_seed, cache_path=cache)
                cache = default_cache_path(
                    args.raw_cache_dir, files, base_hw, "none"
                ) if args.raw_cache_dir else None
                return NativePretrainLoader(
                    files, args.batch_size, base_hw,
                    threads=threads, seed=loader_seed, cache_path=cache,
                )
            if loader_seed == args.seed:
                logger.info("native loader unavailable "
                            f"({(build_error() or '').strip()[-300:]}); "
                            "using the Python loader (PIL)")
        return HostDataLoader(
            PretrainDataSource(files, base_hw, with_region_maps=with_region),
            args.batch_size, shuffle=True, drop_last=True, seed=loader_seed,
            num_workers=args.num_workers,
        )

    # three streams: foreground two-crop + two backgrounds (main.py:281-283)
    loader_fg = make_loader(args.seed, with_region=need_region)
    loader_bg0 = make_loader(args.seed + 1024)
    loader_bg1 = make_loader(args.seed + 2048)
    logger.info(f"decoder: {type(loader_fg).__name__}")
    steps_per_epoch = len(loader_fg)
    if steps_per_epoch == 0:
        raise ValueError("dataset smaller than one batch")

    schedule = (
        (lambda step: args.lr)
        if args.remove_lr_scheduler
        else cosine_lr_schedule(args.lr, args.epochs, steps_per_epoch)
    )
    tx = make_optimizer(args.optim, args.lr, momentum=args.momentum,
                        weight_decay=args.weight_decay)

    aug_cfg = AugmentConfig(
        out_hw=hw,
        erase_scale=(args.foreground_min, args.foreground_max),
        pixel_ids_stride=hp.pixel_ids_stride,
    )

    def augment_fn(generator, raw):
        return pretrain_batch_augment(generator, raw, aug_cfg)

    os_ = dense_output_stride_of(model_cfg, args.backbone_type,
                                 hp.unet_truncated_dec_blocks)
    bos = backbone_output_stride_of(model_cfg, args.backbone_type,
                                    hp.unet_truncated_dec_blocks)
    # the quiet step runs most iterations; the metrics step (the full
    # reference scalar families) only on logging steps, and the visual
    # step (level 2, CP2/PROPOSED) on the first batch of a visual epoch.
    # Every step carries the cheap epoch family unless --metrics_level 0
    want_epoch_scalars = args.metrics_level > 0

    def make_step(metrics_level):
        return make_pretrain_step(hp, os_, backbone_output_stride=bos,
                                  metrics_level=metrics_level,
                                  epoch_scalars=want_epoch_scalars, augment_fn=augment_fn)

    step_fn = make_step(0)
    step_fn_metrics = make_step(args.metrics_level) if args.metrics_level > 0 else step_fn
    visuals_on = (args.visual_freq > 0 and args.metrics_level > 0
                  and args.pretrain_type in (PretrainType.CP2, PretrainType.PROPOSED))
    step_fn_visual = make_step(2) if visuals_on else step_fn_metrics

    state = create_pretrain_state(model, tx, hp, seed=args.seed, device=device)
    if args.imagenet_checkpoint and not args.pretrain_from_scratch:
        load_imagenet_backbone(state, args.imagenet_checkpoint, logger)

    start_epoch = args.start_epoch
    if args.resume:
        # a single checkpoint dir, or a run dir whose latest checkpoint (if
        # any yet) is used; a fresh run dir starts from scratch
        path = args.resume if is_checkpoint(args.resume) else latest_checkpoint(args.resume)
        if path:
            state, meta = restore_checkpoint(path, state)
            start_epoch = int(meta.get("epoch", 0))
            logger.info(f"resumed from {path} (epoch {start_epoch})")
        else:
            logger.info(f"no checkpoint found at {args.resume}")

    def write_visuals(metrics, epoch):
        """Epoch-start artifacts (reference builder.py:1441-1549)."""
        from cp2_tpu_torch.utils import visualize as viz

        vis = {k.split("/", 1)[1]: v.float().cpu().numpy()
               for k, v in metrics.items() if k.startswith("_visual/")}
        if not vis:
            return
        out_dir = os.path.join(run_dir, "visuals", f"epoch_{epoch:04d}")
        os.makedirs(out_dir, exist_ok=True)
        paths = [
            viz.iou_histogram(vis["ious"], os.path.join(out_dir, "iou_histogram.png")),
            viz.iou_histogram(vis["ious_masked"],
                              os.path.join(out_dir, "masked_iou_histogram.png"),
                              title="Histogram of Masked IoU values"),
        ]
        s2 = vis["logits_dense"].shape[1]
        g = int(round(s2 ** 0.5))
        k = min(4, vis["logits_dense"].shape[0])
        paths.append(viz.dense_similarity_heatmaps(
            vis["logits_dense"][:k], vis["mask_a"][:k], vis["mask_b"][:k],
            (g, g), os.path.join(out_dir, "similarity_heatmaps.png")))
        paths.append(viz.example_grid(
            {"img_a": vis["img_a"][:8], "img_b": vis["img_b"][:8]},
            os.path.join(out_dir, "train_examples.png")))
        metrics_sink.log_images({"visuals": paths}, step=step)

    to_device = HostToDevice(device)

    def stage(item):
        """Host batches → device tensors (on the prefetch thread, so the
        copy of batch i+1 overlaps step i)."""
        fg, bg0, bg1 = item
        raw = {"fg": fg["image"], "bg0": bg0["image"], "bg1": bg1["image"]}
        if need_region:
            # NativePairLoader calls the map "mask", PretrainDataSource
            # "region_map"
            raw["region_maps"] = fg["mask"] if "mask" in fg else fg["region_map"]
        if args.same_foreground:
            raw["bg1"] = raw["bg0"]
        return to_device(raw)

    step = state.step
    # exact epoch means (reference on_train_epoch_end averages every step,
    # builder.py:1608-1664): a device-side running sum, read at epoch end
    epoch_names = epoch_scalar_names(args.pretrain_type)
    epoch_vec_sum = None
    epoch_vec_count = 0
    for epoch in range(start_epoch, args.epochs):
        batch_time = AverageMeter("Time", ":6.3f")
        loss_meter = AverageMeter("Loss", ":.4f")
        progress = ProgressMeter(steps_per_epoch, [batch_time, loss_meter], logger,
                                 prefix=f"Epoch: [{epoch}]")
        metrics_sink.log({"epoch": epoch, "update-step": step,
                          "learning_rate": float(schedule(step))}, step=step)
        end = time.time()
        iters = zip(loader_fg.epoch_iterator(epoch), loader_bg0.epoch_iterator(epoch),
                    loader_bg1.epoch_iterator(epoch))
        staged = (DevicePrefetcher(iters, stage, depth=args.prefetch_depth)
                  if args.prefetch_depth > 0 else map(stage, iters))
        for i, batch in enumerate(staged):
            if step > args.max_steps:
                if hasattr(staged, "close"):
                    staged.close()  # stop the prefetch thread promptly
                break
            log_now = i % args.scalar_freq == 0 and args.metrics_level > 0
            visual_now = visuals_on and i == 0 and epoch % args.visual_freq == 0
            run = step_fn_visual if visual_now else step_fn_metrics if log_now else step_fn
            for group in state.optimizer.param_groups:
                group["lr"] = float(schedule(state.step))
            state, metrics = run(state, batch.wait(), seed)
            if want_epoch_scalars:
                vec = metrics["_epoch_vec"].double()
                epoch_vec_sum = vec if epoch_vec_sum is None else epoch_vec_sum + vec
                epoch_vec_count += 1
            if i % args.print_freq == 0:
                loss_meter.update(float(metrics["loss"]))
                batch_time.update(time.time() - end)
                progress.display(i)
            if visual_now:
                write_visuals(metrics, epoch)
            if log_now or visual_now:
                metrics_sink.log({k: float(v) for k, v in metrics.items()
                                  if not k.startswith(("_visual/", "_epoch"))},
                                 step=step)
            end = time.time()
            step += 1

        if epoch_vec_count:
            sums = epoch_vec_sum.cpu().numpy()
            metrics_sink.log({name: float(v / epoch_vec_count)
                              for name, v in zip(epoch_names, sums)}, step=step)
            epoch_vec_sum = None
            epoch_vec_count = 0

        is_last = epoch >= args.epochs - 1
        if epoch % args.ckpt_freq == args.ckpt_freq - 1 or step > args.max_steps or is_last:
            path = save_checkpoint(
                run_dir, step, state,
                meta={"epoch": epoch + 1, "pretrain_type": args.pretrain_type.name,
                      "backbone_type": args.backbone_type.name},
                async_save=args.async_ckpt,
            )
            logger.info(f"saved checkpoint {path}")
            if args.keep_ckpts > 0:
                wait_for_checkpoints()  # never GC around an in-flight save
                dropped = gc_checkpoints(run_dir, args.keep_ckpts)
                if dropped:
                    logger.info(f"gc'd checkpoints {dropped}")
        if step > args.max_steps:
            break
    wait_for_checkpoints()
    metrics_sink.close()
    return state


def load_imagenet_backbone(state, checkpoint_path: str, logger=None) -> None:
    """Graft a torchvision-layout ResNet checkpoint into the query encoder's
    backbone and copy the query encoder, BatchNorm statistics included, into
    the EMA key encoder (``cp2_tpu/train/pretrain.py:683-718``)."""
    from cp2_tpu_torch.checkpoint.convert import graft_imagenet_backbone, read_torch_checkpoint

    state_dict, _ = read_torch_checkpoint(checkpoint_path)
    report = graft_imagenet_backbone(state.model, state_dict)
    state.ema_model.load_state_dict(state.model.state_dict())
    if logger is not None:
        logger.info(f"imagenet init: {len(report['loaded'])} tensors loaded, "
                    f"{len(report['missing_in_source'])} missing")


if __name__ == "__main__":
    main(get_args())
