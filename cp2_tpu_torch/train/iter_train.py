"""mmseg-style iteration-based training CLI of the port.

Port of ``tools/train.py`` (the reference's legacy path → ``train_segmentor``,
``mmseg_/apis/train.py:34-120``): a full python config describes model +
data + schedule; training is iteration-based with periodic mIoU evaluation
and checkpointing — the workflow of VOC-style benchmark runs.

Config surface (python file), as ``tools/train.py`` reads it:
  model        — segmentor dict (same registry names; any backbone, neck
                 and head the port registers)
  data         — dict(train=..., val=...) each with img_dir, ann_dir,
                 img_size, batch_size
  optimizer    — dict(type='SGD'|'Adam', lr=..., momentum=..., weight_decay=...)
  lr_config    — dict(policy='poly', power=0.9, min_lr=1e-4)
  runner       — dict(max_iters=...)
  checkpoint_config / evaluation — dict(interval=...)

Run: ``python -m cp2_tpu_torch.train.iter_train CONFIG --work-dir DIR``.
It runs on the card; ``main(args, device="cpu")`` runs it on the CPU, as
the tests do.  ``torchrun --nproc_per_node N -m
cp2_tpu_torch.train.iter_train CONFIG ...`` runs one process per card: the
config's ``batch_size`` is the global batch, each rank loads its rows
(``shard=(rank, N)``), the eval's intersection and union counts are summed
over the ranks, and rank 0 writes the log and the checkpoints.

What the JAX CLI does and this one does as well: SGD is optax's
``chain(add_decayed_weights, sgd)`` (``make_sgd``), any other type
``adam(lr)`` without decay, both at the poly rate of the optimizer's step
count; batches come from the same host loaders (SmallestMaxSize + random
crop for train, the centre crop for val); each iteration's dropout draws
from a generator seeded by ``(seed, iteration)``, the counterpart of
``fold_in(root_key, it)``; ``validate`` drops the loader's pad rows.
Where it differs:

* ``--resume-from`` continues where the run stopped: the weights, the
  optimizer (momentum) and the iteration counter, and the data order too
  (the epoch and the batch within it), so that a resumed run takes the
  batches the uninterrupted run would have.  The JAX CLI restarts the data
  at epoch 0.
* ``--load-from`` carries the weights only (mmseg's ``load_from``); the
  JAX CLI's restore also brings the optimizer's state.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

LOG_EVERY = 50


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="Train a segmentor (iter-based)")
    parser.add_argument("config", help="train config file path")
    parser.add_argument("--work-dir", default=None)
    parser.add_argument("--load-from", default=None)
    parser.add_argument("--resume-from", default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--no-validate", action="store_true")
    return parser.parse_args(argv)


def poly_lr(base_lr: float, max_iters: int, power: float = 0.9, min_lr: float = 1e-4):
    """``step -> lr``, the JAX schedule in float32: ``max(base_lr · (1 −
    clip(step / max_iters, 0, 1))^power, min_lr)``, with ``step`` the
    optimizer's count of updates so far (0 at the first), as optax's."""
    f32 = np.float32

    def schedule(step: int) -> float:
        frac = np.clip(f32(step) / f32(max_iters), f32(0.0), f32(1.0))
        return float(np.maximum(f32(base_lr) * (f32(1.0) - frac) ** f32(power), f32(min_lr)))

    return schedule


def main(args, device="cuda"):
    """Train as the config says, on ``device``; returns a summary: the final
    eval, the last iteration, its loss and each eval's seconds.

    The default device is the card (``cuda:LOCAL_RANK`` under ``torchrun``):
    with none present this raises, it never carries on on the CPU.  With
    ``torchrun``'s environment set it joins that process group first and
    leaves it at the end (``parallel.process_group``).
    """
    from cp2_tpu_torch.parallel import process_group

    with process_group(device) as layout:
        return _train(args, layout)


def _train(args, layout):
    from cp2_tpu_torch.checkpoint import restore_checkpoint, save_checkpoint
    from cp2_tpu_torch.checkpoint.io import STATE_NAME
    from cp2_tpu_torch.config import Config
    from cp2_tpu_torch.data import HostDataLoader, SegmentationDataSource, list_image_mask_pairs
    from cp2_tpu_torch.data.prefetch import DevicePrefetcher, HostToDevice
    from cp2_tpu_torch.models import build_segmentor
    from cp2_tpu_torch.models.layers import init_flax_like_
    from cp2_tpu_torch.ops.metrics import ConfusionState, eval_metrics, intersect_and_union
    from cp2_tpu_torch.parallel import barrier, check_replicas, pmean_metrics, psum_metrics
    from cp2_tpu_torch.ssl.train_step import step_generator
    from cp2_tpu_torch.train.segmentation_task import (
        build_decode_loss,
        create_seg_state,
        make_adam,
        make_seg_steps,
        make_sgd,
        seg_forward,
        set_learning_rate,
    )
    from cp2_tpu_torch.utils import seed_everything, setup_logger

    cfg = Config.fromfile(args.config)
    work_dir = args.work_dir or os.path.join(
        "./work_dirs", os.path.splitext(os.path.basename(args.config))[0])
    os.makedirs(work_dir, exist_ok=True)
    logger = setup_logger("train", work_dir if layout.is_main else None)
    seed = seed_everything(args.seed)
    device = layout.device

    data_cfg = cfg.data
    num_classes = cfg.model["decode_head"].get("num_classes") or 2
    img_size = data_cfg["train"].get("img_size", 512)
    batch_size = data_cfg["train"].get("batch_size", 8)
    hw = (img_size, img_size)

    train_pairs = list_image_mask_pairs(data_cfg["train"]["img_dir"],
                                        data_cfg["train"]["ann_dir"])
    val_pairs = list_image_mask_pairs(data_cfg["val"]["img_dir"], data_cfg["val"]["ann_dir"])
    # each rank loads its rows of the global batch (tools/train.py:94-107)
    local_batch = layout.local_batch(batch_size)
    train_loader = HostDataLoader(
        SegmentationDataSource(train_pairs, img_size, num_classes, random_crop=True),
        local_batch, shuffle=True, seed=args.seed, shard=layout.shard)
    val_loader = HostDataLoader(
        SegmentationDataSource(val_pairs, img_size, num_classes, random_crop=False),
        local_batch, shuffle=False, drop_last=False, shard=layout.shard)
    if len(train_loader) == 0:
        raise ValueError(f"{len(train_pairs)} train pairs make no batch of {batch_size}")

    model = build_segmentor(cfg)
    init_flax_like_(model, torch.Generator().manual_seed(args.seed))
    opt_cfg = cfg.get("optimizer", {"type": "SGD", "lr": 0.01, "momentum": 0.9})
    lr_cfg = cfg.get("lr_config", {"policy": "poly", "power": 0.9, "min_lr": 1e-4})
    max_iters = cfg.get("runner", {}).get("max_iters", 40000)
    lr = poly_lr(opt_cfg["lr"], max_iters, lr_cfg.get("power", 0.9), lr_cfg.get("min_lr", 1e-4))
    if opt_cfg["type"].upper() == "SGD":
        tx = make_sgd(lr(0), opt_cfg.get("momentum", 0.9), opt_cfg.get("weight_decay", 0.0))
    else:
        tx = make_adam(lr(0), 0.0)
    state = create_seg_state(model, tx, device)

    start_iter = 0
    if args.resume_from or args.load_from:
        barrier()  # rank 0's checkpoint writes are complete before any rank reads
    if args.resume_from:
        # mmseg resume: weights + optimizer + iteration counter
        state, meta = restore_checkpoint(args.resume_from, state)
        start_iter = int(meta.get("iter", state.step))
        logger.info(f"resumed from {args.resume_from} at iter {start_iter}")
    elif args.load_from:
        payload = torch.load(os.path.join(args.load_from, STATE_NAME), map_location=device,
                             weights_only=True)
        state.model.load_state_dict(payload["model"])
        logger.info(f"loaded weights from {args.load_from}")
    check_replicas(state.model.parameters())

    # decode_head.loss_decode + sampler (Dice/Lovász/OHEM); default CE: None
    decode_loss = build_decode_loss(dict(cfg.model.get("decode_head", {})))
    train_step, _, _ = make_seg_steps(num_classes, hw, loss_fn=decode_loss)
    ckpt_interval = cfg.get("checkpoint_config", {}).get("interval", 4000)
    eval_interval = cfg.get("evaluation", {}).get("interval", 4000)
    to_device = HostToDevice(device)
    eval_seconds = []

    def validate():
        t0 = time.perf_counter()
        totals = [torch.zeros(num_classes, dtype=torch.int64, device=device) for _ in range(4)]
        state.model.eval()
        with torch.no_grad():
            for host in val_loader.epoch_iterator(0):
                # drop the pad rows of the final short batch (the loader
                # repeats its last sample to keep the batch size)
                v = int(np.sum(host["valid"]))
                batch = to_device({"image": host["image"][:v], "mask": host["mask"][:v]}).wait()
                images = batch["image"].to(torch.float32) / 255.0
                _, preds = seg_forward(state.model, images, hw)
                parts = intersect_and_union(preds, batch["mask"], num_classes)
                totals = [t + p for t, p in zip(totals, parts)]
        state.model.train()
        # every rank's images: the counts summed over the ranks
        totals = list(psum_metrics(dict(enumerate(totals))).values())
        out = eval_metrics(*totals, metrics=("mIoU",))
        result = {k: v.cpu().numpy().tolist() for k, v in out.items()}
        eval_seconds.append(time.perf_counter() - t0)
        return result

    iters_per_epoch = len(train_loader)
    it = start_iter
    epoch, skip = divmod(start_iter, iters_per_epoch)
    confusion = ConfusionState.create(num_classes, device)
    while it < max_iters:
        staged = DevicePrefetcher(train_loader.epoch_iterator(epoch), to_device)
        try:
            for i, item in enumerate(staged):
                batch = item.wait()
                if i < skip:
                    continue
                set_learning_rate(state.optimizer, lr(state.step))
                images = batch["image"].to(torch.float32) / 255.0
                state, confusion, m = train_step(
                    state, {"image": images, "mask": batch["mask"]},
                    step_generator(seed, it, device), confusion)
                it += 1
                if it % LOG_EVERY == 0:
                    loss = float(pmean_metrics({"loss": m["loss"]})["loss"])
                    logger.info(f"iter {it}/{max_iters} loss={loss:.4f}")
                if not args.no_validate and it % eval_interval == 0:
                    logger.info(f"eval@{it}: {validate()}")
                if (it % ckpt_interval == 0 or it >= max_iters) and layout.is_main:
                    save_checkpoint(work_dir, it, state, meta={"iter": it})
                if it >= max_iters:
                    break
        finally:
            staged.close()
        skip = 0
        epoch += 1
    final = validate()
    logger.info(f"final eval: {final}")
    return {"final_eval": final, "iter": it, "eval_seconds": eval_seconds,
            "loss": (float(pmean_metrics({"loss": m["loss"]})["loss"])
                     if it > start_iter else None)}


if __name__ == "__main__":
    main(get_args())
