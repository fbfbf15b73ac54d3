"""CutPaste/"mirror" pretraining entry point of the port (CLI-compatible with
the JAX package's ``cp2_tpu/train/mirror_pretrain.py`` and the reference's
mirror_pretrain.py).

Host streams decode base frames (``hw + 32`` a side) and mirror frames
from an independently shuffled stream; they are pinned and copied to the
card a batch ahead.  Each step prepares the batch on the card (a resized
crop of each frame, colour jitter, then CutPaste; ``prepare``) and runs the
mirror train step (``train/mirror_task.py``).  Each epoch ends with a val
loop over padded batches, ``val_loss_epoch`` in the metrics, and a
checkpoint on every new best ``val_loss`` tagged ``pretrain_type MIRROR``,
which the finetune CLI's ``--pretrain_type MIRROR`` loads.  The decode
head is the classifier branch (``contrast=False``), as in the reference.

Run: ``python -m cp2_tpu_torch.train.mirror_pretrain --run_id r0 --log_dir
/tmp/logs --data_dirs <dir>`` (``train.csv`` and ``val.csv`` in each
directory list its splits).

It runs on the card; ``main(args, device="cpu")`` runs it on the CPU, as
the tests do.  ``torchrun --nproc_per_node N -m
cp2_tpu_torch.train.mirror_pretrain ...`` runs one process per card:
``--batch-size`` is the global batch, each rank loads and prepares its
rows (the draws are the global batch's), and the val loss and the logged
train losses are means over the ranks; rank 0 writes the logs, metrics
and checkpoints.
"""

from __future__ import annotations

import argparse
import os
from typing import NamedTuple, Optional, Tuple

import torch

from cp2_tpu_torch.augment import functional as F
from cp2_tpu_torch.augment.cutpaste import (
    CutPasteConfig,
    CutPasteParams,
    apply_cutpaste,
    sample_cutpaste,
)
from cp2_tpu_torch.parallel import current_layout, take_rows
from cp2_tpu_torch.types import MirrorVariant

# generator streams of one step (``ssl.train_step.step_generator``)
AUG_STREAM, DROPOUT_STREAM = 0, 1
VAL_STEP_OFFSET = 10_000_000  # val batch i draws from step 10_000_000 + i
CROP_SCALE = (0.2, 1.0)
JITTER_P = 0.75


def get_args(argv=None):
    parser = argparse.ArgumentParser(
        description="CutPaste/mirror pretraining on an NVIDIA card")
    # fmt: off
    parser.add_argument('--config', default=None)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--run_id', type=str, required=True)
    parser.add_argument('--tags', nargs='+', default=[])
    parser.add_argument('--data_dirs', nargs='+', required=True)
    parser.add_argument('--log_dir', type=str, required=True)
    parser.add_argument('--wandb_project', type=str, default='ssl-pretraining')
    parser.add_argument('--wandb_team', type=str, default=None)
    parser.add_argument('--use_wandb', action='store_true')
    parser.add_argument('--offline_wandb', action='store_true')
    parser.add_argument('--num-workers', type=int, default=4, dest='num_workers')
    parser.add_argument('--native_loader', action='store_true', default=True,
                        help='use the C++ decode pool when available')
    parser.add_argument('--no-native_loader', dest='native_loader',
                        action='store_false')
    parser.add_argument('--raw_cache_dir', type=str, default=None,
                        help='directory for the native raw-frame cache '
                             '(decode+resize once, mmap after)')
    parser.add_argument('--fast_dev_run', action='store_true')
    parser.add_argument('--use_profiler', action='store_true')
    parser.add_argument('--prefetch_depth', default=2, type=int,
                        help='device-resident input batches staged ahead '
                             '(0 disables the background copy thread)')

    parser.add_argument('-x', '--img_x_size', type=int, default=512)
    parser.add_argument('-y', '--img_y_size', type=int, default=512)
    parser.add_argument('--num_classes', type=int, default=2)
    parser.add_argument('--lemon_data', action='store_true')

    parser.add_argument('--softmax_temp', type=float, default=2)
    parser.add_argument('--lmbd_compare_loss', type=float, default=0.01)
    parser.add_argument('--variant', choices=[x.name for x in MirrorVariant],
                        default=MirrorVariant.OUTPUT.name)
    parser.add_argument('--max_num_patches', type=int, default=1)
    parser.add_argument('--min_area_scale', type=float, default=0.02)
    parser.add_argument('--max_area_scale', type=float, default=0.15)
    parser.add_argument('--min_aspect_ratio', type=float, default=1/3)
    parser.add_argument('--max_aspect_ratio', type=float, default=4/3)
    parser.add_argument('--min_rotation', type=int, default=0)
    parser.add_argument('--max_rotation', type=int, default=0)

    parser.add_argument('--batch-size', type=int, default=10, dest='batch_size')
    parser.add_argument('--lr', type=float, default=0.001)
    parser.add_argument('--epochs', type=int, default=200)
    parser.add_argument('--weight_decay', type=float, default=1e-4)
    parser.add_argument('--bf16', action='store_true', default=True)
    parser.add_argument('--no-bf16', dest='bf16', action='store_false')
    # fmt: on

    args = parser.parse_args(argv)
    args.log_dir = os.path.abspath(os.path.expanduser(args.log_dir))
    args.variant = MirrorVariant[args.variant]
    if args.lemon_data:
        args.img_x_size = 544
        args.img_y_size = 1024
        args.epochs = 200
        args.max_area_scale = 0.007
        args.min_area_scale = 0.0003
        args.max_num_patches = 1
    if args.fast_dev_run:
        args.epochs = 1
    return args


def cutpaste_config(args) -> CutPasteConfig:
    return CutPasteConfig(
        num_classes=args.num_classes,
        max_num_patches=args.max_num_patches,
        min_area_scale=args.min_area_scale,
        max_area_scale=args.max_area_scale,
        min_aspect_ratio=args.min_aspect_ratio,
        max_aspect_ratio=args.max_aspect_ratio,
        min_rotation=args.min_rotation,
        max_rotation=args.max_rotation,
    )


class BaseViewParams(NamedTuple):
    crop: F.CropParams
    jitter: F.JitterParams


class PrepareParams(NamedTuple):
    """Every draw of one ``prepare`` call."""

    base: BaseViewParams
    mirror: Optional[BaseViewParams]
    cutpaste: CutPasteParams


def _sample_view(generator, n, src_hw) -> BaseViewParams:
    return BaseViewParams(F.sample_resized_crop(generator, n, src_hw, CROP_SCALE),
                          F.sample_color_jitter(generator, n, p=JITTER_P))


def sample_prepare_params(generator: torch.Generator, n: int, src_hw: Tuple[int, int],
                          hw: Tuple[int, int], cfg: CutPasteConfig,
                          with_mirror: bool) -> PrepareParams:
    """Draw a batch's crops (scale (0.2, 1.0), flips at 0.5), jitters
    (p = 0.75, the fixed order 0) and CutPaste on ``generator``'s device;
    ``n`` is this rank's row count, and every draw covers the global batch
    (``parallel.take_rows``)."""
    layout = current_layout()
    base = take_rows(_sample_view(generator, n * layout.world, src_hw), layout)
    mirror = (take_rows(_sample_view(generator, n * layout.world, src_hw), layout)
              if with_mirror else None)
    return PrepareParams(base, mirror, sample_cutpaste(generator, n, hw, cfg))


def _base_view(frames: torch.Tensor, p: BaseViewParams, hw) -> torch.Tensor:
    img = frames.to(torch.float32) / 255.0
    return F.color_jitter(F.crop_resize_bilinear(img, p.crop, hw), p.jitter)


def apply_prepare(frames: torch.Tensor, mirror_frames: Optional[torch.Tensor],
                  params: PrepareParams, hw: Tuple[int, int]):
    """The batch of ``mirror_pretrain.py:229-247`` from uint8 frames (N, H,
    W, 3): ``image``, ``mask``, ``target`` and, with mirror parameters,
    ``mirror``."""
    base = _base_view(frames, params.base, hw)
    mirrors = None if params.mirror is None else _base_view(mirror_frames, params.mirror, hw)
    image, mirrors, mask, target = apply_cutpaste(base, mirrors, params.cutpaste)
    batch = {"image": image, "mask": mask, "target": target}
    if mirrors is not None:
        batch["mirror"] = mirrors
    return batch


def prepare(generator: torch.Generator, frames: torch.Tensor,
            mirror_frames: Optional[torch.Tensor], hw: Tuple[int, int],
            cfg: CutPasteConfig, variant: MirrorVariant):
    """Sample on ``generator`` and apply: the base geometric/photometric
    transform and CutPaste, on the frames' device."""
    with_mirror = variant == MirrorVariant.OUTPUT
    params = sample_prepare_params(generator, frames.shape[0], tuple(frames.shape[1:3]), hw,
                                   cfg, with_mirror)
    return apply_prepare(frames, mirror_frames if with_mirror else None, params, hw)


def main(args, device="cuda"):
    """Pretrain as the flags say, on ``device``; returns the final state.

    The default device is the card (``cuda:LOCAL_RANK`` under ``torchrun``):
    with none present this raises, it never carries on on the CPU.  With
    ``torchrun``'s environment set it joins that process group first and
    leaves it at the end (``parallel.process_group``).
    """
    from cp2_tpu_torch.parallel import process_group

    with process_group(device) as layout:
        return _pretrain(args, layout)


def _pretrain(args, layout):
    import cp2_tpu_torch
    from cp2_tpu_torch.checkpoint import save_checkpoint
    from cp2_tpu_torch.config import Config
    from cp2_tpu_torch.data import HostDataLoader, PretrainDataSource
    from cp2_tpu_torch.data.datasets import get_pretrain_files
    from cp2_tpu_torch.data.prefetch import DevicePrefetcher, HostToDevice
    from cp2_tpu_torch.models import build_segmentor
    from cp2_tpu_torch.models.layers import init_flax_like_
    from cp2_tpu_torch.ops.metrics import ConfusionState
    from cp2_tpu_torch.parallel import check_replicas, pmean_metrics, psum_metrics
    from cp2_tpu_torch.ssl.train_step import step_generator
    from cp2_tpu_torch.train.mirror_task import make_mirror_steps
    from cp2_tpu_torch.train.segmentation_task import create_seg_state, make_adam
    from cp2_tpu_torch.types import DatasetType
    from cp2_tpu_torch.utils import MetricLogger, NullSink, seed_everything, setup_logger

    device = layout.device
    seed = seed_everything(args.seed)
    run_dir = os.path.join(args.log_dir, args.run_id)
    os.makedirs(run_dir, exist_ok=True)
    logger = setup_logger("mirror", run_dir if layout.is_main else None)
    sink = MetricLogger(
        args.log_dir, args.run_id, use_wandb=args.use_wandb,
        wandb_project=args.wandb_project, wandb_team=args.wandb_team,
        offline=args.offline_wandb, config={"hyper-parameters": vars(args)},
        tags=["cutpaste"] + args.tags,
    ) if layout.is_main else NullSink()

    hw = (args.img_x_size, args.img_y_size)
    train_files = get_pretrain_files(args.data_dirs, DatasetType.CSV, "train")
    val_files = get_pretrain_files(args.data_dirs, DatasetType.CSV, "val")
    base_hw = (hw[0] + 32, hw[1] + 32)
    if not train_files:
        raise ValueError("train split is empty — check --data_dirs")
    if args.batch_size > len(train_files):
        # tiny smoke datasets: a drop_last train loader would yield 0 steps
        # (a multiple of the process count, as in the finetune CLI)
        eff = max(len(train_files) // layout.world * layout.world, 1)
        logger.warning(f"batch_size {args.batch_size} > train files "
                       f"{len(train_files)}; clamping to {eff}")
        args.batch_size = eff
    # each rank loads its rows (cp2_tpu/train/mirror_pretrain.py:149-155)
    local_batch = layout.local_batch(args.batch_size)
    if args.raw_cache_dir:
        os.makedirs(args.raw_cache_dir, exist_ok=True)
    said_native = []

    def loader(files, shuffle, loader_seed):
        # the mirror path decodes the largest frames (512² / 544×1024): the
        # C++ pool where it builds, else the Python loader (PIL), said once
        if args.native_loader:
            from cp2_tpu_torch.native import (
                NativePretrainLoader,
                build_error,
                default_cache_path,
                native_available,
            )

            if native_available():
                cache = default_cache_path(
                    args.raw_cache_dir, files, base_hw, "none"
                ) if args.raw_cache_dir else None
                return NativePretrainLoader(
                    files, local_batch, base_hw, threads=max(args.num_workers, 1),
                    seed=loader_seed, shuffle=shuffle, drop_last=shuffle,
                    shard=layout.shard, cache_path=cache)
            if not said_native:
                said_native.append(True)
                logger.info("native loader unavailable "
                            f"({(build_error() or '').strip()[-300:]}); "
                            "using the Python loader (PIL)")
        return HostDataLoader(PretrainDataSource(files, base_hw), local_batch,
                              shuffle=shuffle, drop_last=shuffle, seed=loader_seed,
                              num_workers=args.num_workers, shard=layout.shard)

    train_loader = loader(train_files, True, args.seed)
    # mirror base images come from an independently shuffled stream
    mirror_loader = loader(train_files, True, args.seed + 7)
    val_loader = loader(val_files, False, args.seed + 1)
    val_mirror_loader = loader(val_files, False, args.seed + 8)
    logger.info(f"decoder: {type(train_loader).__name__}")

    config_path = args.config or os.path.join(
        os.path.dirname(cp2_tpu_torch.__file__), "configs", "config_finetune.py")
    cfg = Config.fromfile(config_path)
    cfg.model.decode_head.num_classes = args.num_classes
    cfg.model.decode_head["contrast"] = False  # reference :210-211
    model_cfg = dict(cfg.model)
    model_cfg["dtype"] = torch.bfloat16 if args.bf16 else torch.float32
    model = build_segmentor(model_cfg)
    init_flax_like_(model, torch.Generator().manual_seed(args.seed))
    state = create_seg_state(model, make_adam(args.lr, args.weight_decay), device)
    check_replicas(state.model.parameters())

    cut_cfg = cutpaste_config(args)
    train_step, eval_step = make_mirror_steps(
        args.num_classes, hw, mirror_variant=args.variant,
        lmbd_compare_loss=args.lmbd_compare_loss, softmax_temp=args.softmax_temp)
    to_device = HostToDevice(device)

    def stage(pair):
        b, m = pair
        return to_device({"image": b["image"], "mirror": m["image"]})

    step_timer = None
    if args.use_profiler:
        # Lightning profiler="simple" analog (reference mirror_pretrain.py:230)
        from cp2_tpu_torch.utils.profiling import StepTimer

        step_timer = StepTimer()

    best_val = float("inf")
    for epoch in range(args.epochs):
        confusion = ConfusionState.create(args.num_classes, device)
        metrics = {}
        pairs = zip(train_loader.epoch_iterator(epoch), mirror_loader.epoch_iterator(epoch))
        # background copies, as in the pretrain and finetune CLIs: decode,
        # the copy of batch i+1 and step i overlap
        staged = (DevicePrefetcher(pairs, stage, depth=args.prefetch_depth)
                  if args.prefetch_depth > 0 else map(stage, pairs))
        for i, item in enumerate(staged):
            frames = item.wait()
            if step_timer is not None:
                step_timer.start()
            batch = prepare(step_generator(seed, state.step, device, stream=AUG_STREAM),
                            frames["image"], frames["mirror"], hw, cut_cfg, args.variant)
            state, confusion, metrics = train_step(
                state, batch, step_generator(seed, state.step, device, stream=DROPOUT_STREAM),
                confusion)
            if step_timer is not None:
                step_timer.stop(probe=metrics["train_loss"])
            if args.fast_dev_run and i >= 1:
                if hasattr(staged, "close"):
                    staged.close()  # stop the prefetch thread promptly
                break
        val_losses = []
        vconf = ConfusionState.create(args.num_classes, device)
        for i, (b, m) in enumerate(zip(val_loader.epoch_iterator(0),
                                       val_mirror_loader.epoch_iterator(0))):
            frames = to_device({"image": b["image"], "mirror": m["image"],
                                "valid": b["valid"]}).wait()
            batch = prepare(step_generator(seed, VAL_STEP_OFFSET + i, device, stream=AUG_STREAM),
                            frames["image"], frames["mirror"], hw, cut_cfg, args.variant)
            batch["valid"] = frames["valid"]  # pad mask of the drop_last=False loader
            vconf, vm = eval_step(state, batch, vconf)
            val_losses.append((vm["val_loss"].double() * vm["weight"], vm["weight"].double()))
            if args.fast_dev_run and i >= 1:
                break
        val_loss = float("nan")
        if val_losses:
            # the global batch's: the weighted sums over the ranks
            tot = psum_metrics({"loss": sum(v for v, _ in val_losses),
                                "weight": sum(w for _, w in val_losses)})
            val_loss = float(tot["loss"]) / max(float(tot["weight"]), 1e-9)
        sink.log({**{k: float(v) for k, v in pmean_metrics(metrics).items()},
                  "val_loss_epoch": val_loss, "epoch": epoch}, step=state.step)
        logger.info(f"epoch {epoch}: val_loss={val_loss:.4f}")
        if val_loss < best_val:
            best_val = val_loss
            if layout.is_main:
                path = save_checkpoint(run_dir, state.step, state,
                                       meta={"epoch": epoch, "val_loss": val_loss,
                                             "pretrain_type": "MIRROR"})
                logger.info(f"new best val_loss={val_loss:.4f} -> {path}")
        if args.fast_dev_run:
            break
    if step_timer is not None:
        logger.info(f"profiler summary: {step_timer.summary()}")
    sink.close()
    return state


if __name__ == "__main__":
    main(get_args())
