"""Supervised finetune entry point of the port (CLI-compatible with the JAX
package's ``cp2_tpu/train/finetune.py`` and the reference's finetune.py).

Image/mask pairs are decoded and cropped on the host (SmallestMaxSize and a
crop for polyp, a direct resize for lemon), pinned and copied to the card a
batch ahead; each train step co-augments images and masks on the card
(flips, jitter, grid distortion, noise) and runs forward → logits resized
to label resolution → CE → Adam.  Each epoch evaluates val (with the
reference's stochastic flips) and the pseudo-test subset, keeps the best
checkpoint by ``val_BinaryJaccardIndex`` (``val_MulticlassJaccardIndex``
for more than two classes; save_top_k=1), and the run ends with a test pass
on the best weights.

Run: ``python -m cp2_tpu_torch.train.finetune --run_id r0 --log_dir
/tmp/logs --img_dirs <imgs> --mask_dirs <masks> --pretrain_type CP2
--pretrain_path <pretrain run dir>``

It runs on the card; ``main(args, device="cpu")`` runs it on the CPU, as
the tests do.  Pretrained weights load from the port's own checkpoints and
torch-format files (``checkpoint/convert.py``); the port reads no orbax
checkpoint.  More than one process raises ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time

import torch

from cp2_tpu_torch.types import DataSplitType, PretrainType

# generator streams of one step (``ssl.train_step.step_generator``)
AUG_STREAM, DROPOUT_STREAM, EVAL_STREAM = 0, 1, 2


def get_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Supervised segmentation finetune on an NVIDIA card")
    # fmt: off
    parser.add_argument('--config', default=None, help='path to model config')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--run_id', type=str, required=True)
    parser.add_argument('--tags', nargs='+', default=[])
    parser.add_argument('--offline_wandb', action='store_true')
    parser.add_argument('--use_wandb', action='store_true')
    parser.add_argument('--use_backbone_only', action='store_true')

    parser.add_argument('--img_dirs', nargs='+', required=True)
    parser.add_argument('--mask_dirs', nargs='+', required=True)
    parser.add_argument('--train_data_ratio', type=float, default=1.0)
    parser.add_argument('--data_split_type', type=str,
                        choices=[x.name for x in DataSplitType],
                        default=DataSplitType.FILENAME.name)

    parser.add_argument('--log_dir', type=str, required=True)
    parser.add_argument('--wandb_project', type=str, default='ssl-pretraining')
    parser.add_argument('--wandb_team', type=str, default=None)
    parser.add_argument('--num_workers', type=int, default=4)
    parser.add_argument('--native_loader', action='store_true', default=True,
                        help='use the C++ decode pool when available')
    parser.add_argument('--no-native_loader', dest='native_loader',
                        action='store_false')
    parser.add_argument('--raw_cache_dir', type=str, default=None,
                        help='directory for the native raw-frame cache '
                             '(decode+SmallestMaxSize once, mmap after)')
    parser.add_argument('--fast_dev_run', action='store_true')
    parser.add_argument('--use_profiler', action='store_true')
    parser.add_argument('--prefetch_depth', default=2, type=int,
                        help='device-resident batches staged ahead by a '
                             'background thread (overlaps the host-to-device '
                             'copy of batch i+1 with step i); 0 copies inline')

    parser.add_argument('--num_classes', type=int, default=2)
    parser.add_argument('--visualize_freq', type=int, default=10,
                        help='epochs between segmentation-overlay artifacts '
                             '(reference CustomCallback every_n_epochs=10); '
                             '0 disables')
    parser.add_argument('--lemon_data', action='store_true')
    parser.add_argument('--img_height', default=352, type=int)
    parser.add_argument('--img_width', default=352, type=int)

    parser.add_argument('--batch_size', type=int, default=16)
    parser.add_argument('--learning_rate', type=float, default=1e-4)
    parser.add_argument('--epochs', type=int, default=100)
    parser.add_argument('--weight_decay', type=float, default=1e-4)

    parser.add_argument('--pretrain_path', type=str, default='')
    parser.add_argument('--pretrain_type', type=str,
                        choices=[x.name for x in PretrainType], required=True)
    parser.add_argument('--linear_evaluation', action='store_true')
    parser.add_argument('--bf16', action='store_true', default=True)
    parser.add_argument('--no-bf16', dest='bf16', action='store_false')
    # fmt: on

    args = parser.parse_args(argv)
    if len(args.img_dirs) != 1 or len(args.mask_dirs) != 1:
        raise ValueError("exactly one image dir and one mask dir supported")
    args.pretrain_type = PretrainType[args.pretrain_type]
    args.data_split_type = DataSplitType[args.data_split_type]
    if args.lemon_data:
        args.img_height = 544
        args.img_width = 1024
        args.num_classes = 12
        args.epochs = 200
    if args.fast_dev_run:
        args.epochs = 1
    return args


def load_any_checkpoint(path: str):
    """``(state_dict, meta)`` of a pretrained checkpoint: the port's own
    (a step directory holding ``state.pt`` and ``meta.json``: its
    ``model``), or a torch-format file (downloaded baselines; a
    ``state_dict`` or ``model`` entry is unwrapped, its scalar fields kept
    as meta).  An orbax directory of the JAX package is refused."""
    from cp2_tpu_torch.checkpoint.io import META_NAME, STATE_NAME

    if os.path.isdir(path):
        state_file = os.path.join(path, STATE_NAME)
        if not os.path.isfile(state_file):
            raise ValueError(
                f"{path} holds no {STATE_NAME}: the port reads its own checkpoints and "
                "torch-format files, no orbax checkpoint (carry JAX weights through "
                "cp2_tpu_torch/checkpoint/bridge.py)")
        payload = torch.load(state_file, map_location="cpu", weights_only=True)
        meta = {}
        meta_path = os.path.join(path, META_NAME)
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
        return payload["model"], meta
    from cp2_tpu_torch.checkpoint.convert import read_torch_checkpoint

    return read_torch_checkpoint(path)


def main(args, device="cuda"):
    """Finetune as the flags say, on ``device``; returns the test metrics.

    The default device is the card: with none present this raises, it
    never carries on on the CPU.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError("more than one process is not ported yet")

    import cp2_tpu_torch
    from cp2_tpu_torch.augment import (
        FinetuneAugmentConfig,
        eval_augment_batch,
        finetune_augment_batch,
        lemon_augment_config,
    )
    from cp2_tpu_torch.checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint
    from cp2_tpu_torch.checkpoint.convert import load_pretrained_into_segmentor
    from cp2_tpu_torch.checkpoint.io import is_checkpoint
    from cp2_tpu_torch.config import Config
    from cp2_tpu_torch.data import (
        HostDataLoader,
        SegmentationDataSource,
        get_data_splits,
        list_image_mask_pairs,
        pseudo_test_subset,
    )
    from cp2_tpu_torch.data.prefetch import DevicePrefetcher, HostToDevice
    from cp2_tpu_torch.models import build_segmentor
    from cp2_tpu_torch.models.layers import init_flax_like_
    from cp2_tpu_torch.ops.metrics import ConfusionState
    from cp2_tpu_torch.ssl.train_step import step_generator
    from cp2_tpu_torch.train.segmentation_task import (
        create_seg_state,
        make_adam,
        make_seg_steps,
        seg_forward,
    )
    from cp2_tpu_torch.utils import MetricLogger, seed_everything, setup_logger

    seed = seed_everything(args.seed)
    run_dir = os.path.join(args.log_dir, args.run_id)
    os.makedirs(run_dir, exist_ok=True)
    logger = setup_logger("finetune", run_dir)
    sink = MetricLogger(
        args.log_dir, args.run_id, use_wandb=args.use_wandb,
        wandb_project=args.wandb_project, wandb_team=args.wandb_team,
        offline=args.offline_wandb, config={"hyper-parameters": vars(args)},
        tags=["finetune"] + args.tags,
    )

    # ---------------- data ----------------
    pairs = list_image_mask_pairs(args.img_dirs[0], args.mask_dirs[0])
    splits = get_data_splits(pairs, args.data_split_type, args.train_data_ratio)
    if not splits["train"]:
        raise ValueError("train split is empty — check --img_dirs/--mask_dirs")
    if args.batch_size > len(splits["train"]):
        # smoke runs hand in tiny datasets; a batch larger than the train
        # split would make the (drop_last) train loader yield zero steps
        logger.warning(f"batch_size {args.batch_size} > train split "
                       f"{len(splits['train'])}; clamping to {len(splits['train'])}")
        args.batch_size = len(splits["train"])
    pseudo = pseudo_test_subset(splits["test"], args.batch_size, 1)
    logger.info(f"splits: train={len(splits['train'])} val={len(splits['val'])} "
                f"test={len(splits['test'])} pseudo={len(pseudo)}")
    hw = (args.img_height, args.img_width)
    if args.img_height != args.img_width and not args.lemon_data:
        raise ValueError("square images expected for polyp path")
    # lemon: a direct aspect-breaking resize (reference A.Resize(544, 1024),
    # finetune_dataset.py:349-384); polyp: SmallestMaxSize + crop (:301-349)
    geometry = "resize" if args.lemon_data else "crop"
    if args.raw_cache_dir:
        os.makedirs(args.raw_cache_dir, exist_ok=True)
    said_native = []

    def loader(paths, random_crop, shuffle, loader_seed):
        if args.native_loader:
            from cp2_tpu_torch.native import (
                NativePairLoader,
                build_error,
                default_cache_path,
                native_available,
            )

            if native_available():
                mode = "crop" if geometry == "crop" else "region"
                cache = default_cache_path(
                    args.raw_cache_dir, [p for pr in paths for p in pr], hw, mode,
                ) if args.raw_cache_dir else None
                return NativePairLoader(
                    paths, args.batch_size, hw, mode=mode, random_crop=random_crop,
                    num_classes=args.num_classes, threads=max(args.num_workers, 1),
                    seed=loader_seed, shuffle=shuffle, drop_last=shuffle, cache_path=cache)
            if not said_native:
                said_native.append(True)
                logger.info("native loader unavailable "
                            f"({(build_error() or '').strip()[-300:]}); "
                            "using the Python loader (PIL)")
        src = SegmentationDataSource(paths, hw, args.num_classes, random_crop=random_crop,
                                     seed=loader_seed, mode=geometry)
        return HostDataLoader(src, args.batch_size, shuffle=shuffle, drop_last=shuffle,
                              seed=loader_seed, num_workers=args.num_workers)

    train_loader = loader(splits["train"], True, True, args.seed)
    val_loader = loader(splits["val"], True, False, args.seed + 1)
    test_loader = loader(splits["test"], False, False, args.seed + 2)
    pseudo_loader = loader(pseudo, False, False, args.seed + 3)
    logger.info(f"decoder: {type(train_loader).__name__}")

    # ---------------- model ----------------
    config_path = args.config or os.path.join(
        os.path.dirname(cp2_tpu_torch.__file__), "configs", "config_finetune.py")
    cfg = Config.fromfile(config_path)
    cfg.model.decode_head.num_classes = args.num_classes
    model_cfg = dict(cfg.model)
    model_cfg["dtype"] = torch.bfloat16 if args.bf16 else torch.float32
    model = build_segmentor(model_cfg)
    init_flax_like_(model, torch.Generator().manual_seed(args.seed))

    # pretrain-checkpoint loading matrix (segment_network.py:63-162)
    if args.pretrain_type not in (PretrainType.RANDOM, PretrainType.NONE):
        path = args.pretrain_path
        if os.path.isdir(path) and not is_checkpoint(path):
            path = latest_checkpoint(path) or path
        ckpt_state, meta = load_any_checkpoint(path)
        merged, report = load_pretrained_into_segmentor(
            model.state_dict(), ckpt_state, meta, args.pretrain_type,
            use_backbone_only=args.use_backbone_only)
        logger.info(f"loaded {len(report.get('loaded', []))} tensors from {path}; "
                    f"dropped {report.get('dropped', [])}")
        if not report.get("loaded"):
            # the reference load_state_dicts with strict=False and trains
            # from random init when no key matches (segment_network.py:92)
            raise ValueError(
                f"{args.pretrain_type.name} checkpoint at {path} contributed ZERO tensors "
                "to the segmentor (incompatible backbone or layout); refusing to silently "
                "train from random init")
        model.load_state_dict(merged)

    frozen = None
    if args.linear_evaluation:
        # freeze the backbone (reference finetune.py:219-222)
        def frozen(name):
            return name.startswith("backbone.")

    train_step, eval_step, metrics_of = make_seg_steps(args.num_classes, hw, frozen=frozen)
    state = create_seg_state(model, make_adam(args.learning_rate, args.weight_decay), device)
    aug_cfg = lemon_augment_config() if args.lemon_data else FinetuneAugmentConfig()
    to_device = HostToDevice(device)

    def run_eval(eval_loader, prefix, *, flips=False, epoch=0):
        confusion = ConfusionState.create(args.num_classes, device)
        loss_sum, weight_sum = 0.0, 0.0
        for i, host in enumerate(eval_loader.epoch_iterator(0)):
            batch = to_device(host).wait()
            images = batch["image"].to(torch.float32) / 255.0
            masks = batch["mask"]
            if flips:
                # the reference's val transform is stochastic: polyp flips H
                # and V (finetune_dataset.py:325-336); lemon flips H and
                # distorts (:368-377); draws from (seed, epoch, batch)
                gen = step_generator(seed, (epoch << 20) + i, device, stream=EVAL_STREAM)
                images, masks = eval_augment_batch(
                    gen, images, masks, hflip_p=0.5, vflip_p=0.0 if args.lemon_data else 0.5,
                    distort_p=0.2 if args.lemon_data else 0.0)
            confusion, m = eval_step(state, {"image": images, "mask": masks,
                                             "valid": batch.get("valid")}, confusion)
            w = float(m["weight"])
            loss_sum += float(m["loss"]) * w
            weight_sum += w
        result = {k: float(v) for k, v in metrics_of(confusion, prefix).items()}
        if weight_sum > 0:
            result[f"{prefix}loss"] = loss_sum / weight_sum
        return result

    overlay_batch = []

    def write_overlays(epoch):
        """Image / mask / prediction grids of one val batch (reference
        CustomCallback, finetune.py:86-139), fetched once."""
        from cp2_tpu_torch.utils.visualize import segmentation_overlay_grid

        if not overlay_batch:
            it = val_loader.epoch_iterator(0)
            try:
                overlay_batch.append(next(it))
            except StopIteration:
                return
            for _ in it:  # drain so the loader finishes cleanly
                pass
        host = overlay_batch[0]
        images = to_device({"image": host["image"]}).wait()["image"].to(torch.float32) / 255.0
        state.model.eval()
        with torch.no_grad():
            _, preds = seg_forward(state.model, images, hw)
        state.model.train()
        k = min(8, preds.shape[0])
        path = segmentation_overlay_grid(
            host["image"][:k].astype("float32") / 255.0, host["mask"][:k],
            preds[:k].cpu().numpy(),
            os.path.join(run_dir, "visuals", f"segmentations_epoch_{epoch:04d}.png"))
        sink.log_images({"Segmentations": path}, step=state.step)

    # ---------------- loop ----------------
    step_timer = None
    if args.use_profiler:
        # Lightning profiler="simple" analog (reference finetune.py:232)
        from cp2_tpu_torch.utils.profiling import StepTimer

        step_timer = StepTimer()

    best_iou, best_path = -1.0, None
    monitor = ("val_BinaryJaccardIndex" if args.num_classes == 2
               else "val_MulticlassJaccardIndex")
    for epoch in range(args.epochs):
        if args.visualize_freq > 0 and epoch % args.visualize_freq == 0:
            write_overlays(epoch)
        confusion = ConfusionState.create(args.num_classes, device)
        t0 = time.time()
        iters = train_loader.epoch_iterator(epoch)
        staged = (DevicePrefetcher(iters, to_device, depth=args.prefetch_depth)
                  if args.prefetch_depth > 0 else map(to_device, iters))
        m = None
        for i, item in enumerate(staged):
            batch = item.wait()
            if step_timer is not None:
                step_timer.start()
            images, masks = finetune_augment_batch(
                step_generator(seed, state.step, device, stream=AUG_STREAM),
                batch["image"], batch["mask"], aug_cfg)
            state, confusion, m = train_step(
                state, {"image": images, "mask": masks},
                step_generator(seed, state.step, device, stream=DROPOUT_STREAM), confusion)
            if step_timer is not None:
                step_timer.stop(probe=m["loss"])
            if args.fast_dev_run and i >= 1:
                if hasattr(staged, "close"):
                    staged.close()
                break
        if m is None:
            raise ValueError("the train loader yielded no batch")
        train_metrics = {k: float(v) for k, v in metrics_of(confusion, "train_").items()}
        train_metrics["train_loss"] = float(m["loss"])
        train_metrics["epoch_time"] = time.time() - t0

        val_metrics = run_eval(val_loader, "val_", flips=True, epoch=epoch)
        pseudo_metrics = run_eval(pseudo_loader, "pseudotest_") if pseudo else {}
        sink.log({**train_metrics, **val_metrics, **pseudo_metrics, "epoch": epoch},
                 step=state.step)
        logger.info(f"epoch {epoch}: train_loss={train_metrics['train_loss']:.4f} "
                    f"{monitor}={val_metrics.get(monitor, float('nan')):.4f}")

        if val_metrics.get(monitor, -1.0) > best_iou:
            best_iou = val_metrics[monitor]
            prev_best = best_path
            best_path = save_checkpoint(
                run_dir, state.step, state,
                meta={"epoch": epoch, monitor: best_iou,
                      "pretrain_type": args.pretrain_type.name})
            logger.info(f"new best {monitor}={best_iou:.4f} -> {best_path}")
            if prev_best and prev_best != best_path:
                # save_top_k=1 (reference finetune.py:165-171)
                shutil.rmtree(prev_best, ignore_errors=True)
        if step_timer is not None:
            logger.info(f"profiler summary: {step_timer.summary()}")
        if args.fast_dev_run:
            break

    # final test on the best checkpoint (reference finetune.py:257-274)
    if best_path is not None:
        state, _ = restore_checkpoint(best_path, state)
    test_metrics = run_eval(test_loader, "test_")
    sink.log(test_metrics, step=state.step)
    logger.info(f"test: {test_metrics}")
    sink.close()
    return test_metrics


if __name__ == "__main__":
    main(get_args())
