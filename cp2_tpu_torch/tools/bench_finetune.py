"""Finetune train-step throughput on an NVIDIA card.

Twin of ``tools/bench_finetune.py`` with its flags and JSON keys: the
fused finetune step of the finetune CLI at the reference's envelope
(batch 16, 352², 2 classes, ``config_finetune.py``, a bfloat16 model):
on-device augmentation (flips, jitter, grid distortion, noise), then
``train/segmentation_task.py``'s train step (ResNet-50/ASPP forward and
backward, logit resize, cross-entropy, Adam at 1e-4 with a decay of
1e-4, ``make_adam``), then the confusion update.  Inputs are uint8 images
and masks drawn from ``np.random.RandomState(0)`` as the JAX tool draws
them.

    python -m cp2_tpu_torch.tools.bench_finetune [--hw 352] [--batch 16] [--steps 30]

It counts the first step's FLOPs (``utils/flops.py``) and times
``--steps`` steps after ``--warmup``; ``mfu`` is over the card's dense
bf16 peak.  An earlier ``LAUNCHES`` line gives the dense-loss kernels'
launches beside the steps run.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from cp2_tpu_torch.parallel import resolve_device
from cp2_tpu_torch.utils import benchmarking as bm

SEED = 1  # the JAX tool's jax.random.PRNGKey(1)


def get_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--hw", type=int, default=352)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--num-classes", type=int, default=2)
    return ap.parse_args(argv)


def build(model_cfg: dict, device, num_classes: int, batch: int, hw: int):
    """``(call, state)``: ``call()`` runs one fused step and returns its
    loss; ``call.calls`` counts the steps run."""
    from cp2_tpu_torch.augment import FinetuneAugmentConfig, finetune_augment_batch
    from cp2_tpu_torch.models import build_segmentor
    from cp2_tpu_torch.models.layers import init_flax_like_
    from cp2_tpu_torch.ops.metrics import ConfusionState
    from cp2_tpu_torch.ssl.train_step import step_generator
    from cp2_tpu_torch.train.finetune import AUG_STREAM, DROPOUT_STREAM
    from cp2_tpu_torch.train.segmentation_task import create_seg_state, make_adam, make_seg_steps

    model_cfg = dict(model_cfg, dtype=torch.bfloat16,
                     decode_head=dict(model_cfg["decode_head"], num_classes=num_classes))
    model = build_segmentor(model_cfg)
    init_flax_like_(model, torch.Generator().manual_seed(0))
    # the reference finetune optimizer: Adam lr 1e-4 + wd 1e-4
    state = create_seg_state(model, make_adam(1e-4, 1e-4), device)
    train_step, _, _ = make_seg_steps(num_classes, (hw, hw))
    aug_cfg = FinetuneAugmentConfig()
    r = np.random.RandomState(0)
    images = torch.from_numpy((r.rand(batch, hw, hw, 3) * 255).astype(np.uint8)).to(device)
    masks = torch.from_numpy((r.rand(batch, hw, hw) > 0.7).astype(np.int32)).to(device)
    carry = [ConfusionState.create(num_classes, device)]

    def call():
        img, mask = finetune_augment_batch(
            step_generator(SEED, state.step, device, stream=AUG_STREAM), images, masks,
            aug_cfg)
        _, carry[0], m = train_step(
            state, {"image": img, "mask": mask},
            step_generator(SEED, state.step, device, stream=DROPOUT_STREAM), carry[0])
        return m["loss"]

    return bm.Counted(call), state


class _NoConfusion:
    """The confusion update needs the data (``bincount``) and forms no
    products: the meta pass skips it."""

    def update(self, *args, **kwargs):
        return self


def step_flops(model_cfg: dict, num_classes: int, batch: int, hw: int) -> int:
    """FLOPs of one step of ``build`` from the configuration alone
    (``utils/flops.py``'s count, on the meta device with shapes only; the
    augmentation's parameters are drawn on the CPU): the polyp augmentation
    of raw uint8 images of ``hw``², then the train step with Adam (the
    confusion update forms no products)."""
    from cp2_tpu_torch.augment.pipeline import (
        FinetuneAugmentConfig, apply_finetune_augment, sample_finetune_params)
    from cp2_tpu_torch.models import build_segmentor
    from cp2_tpu_torch.train.segmentation_task import SegTrainState, make_adam, make_seg_steps
    from cp2_tpu_torch.utils.flops import flop_counter

    model_cfg = dict(model_cfg, decode_head=dict(model_cfg["decode_head"],
                                                 num_classes=num_classes))
    with torch.device("meta"):
        model = build_segmentor(model_cfg).train()
    state = SegTrainState(model=model, optimizer=make_adam(1e-4, 1e-4)(model.parameters()))
    train_step, _, _ = make_seg_steps(num_classes, (hw, hw))
    gen = torch.Generator().manual_seed(0)
    with flop_counter() as counter:
        params = sample_finetune_params(gen, batch, (hw, hw), FinetuneAugmentConfig())
        images = torch.empty((batch, hw, hw, 3), dtype=torch.uint8, device="meta")
        masks = torch.empty((batch, hw, hw), dtype=torch.int32, device="meta")
        images, masks = apply_finetune_augment(images, masks, bm.to_meta(params))
        train_step(state, {"image": images, "mask": masks}, gen, _NoConfusion())
    return counter.get_total_flops()


def run(model_cfg: dict, device, args) -> dict:
    """The benchmark of ``args`` on ``device``; returns the JSON line's dict."""
    from cp2_tpu_torch.ops import dense_loss
    from cp2_tpu_torch.utils.flops import mfu, peak_bf16_flops

    device = resolve_device(device)
    bm.reset_peak(device)
    dense_loss.reset_launch_counts()
    call, _ = build(model_cfg, device, args.num_classes, args.batch, args.hw)
    flops, dt, _ = bm.count_and_time(call, warmup=args.warmup, steps=args.steps,
                                     device=device)
    dt /= args.steps
    bm.print_launches(call.calls)
    share = mfu(flops, 1, dt, peak_bf16_flops(bm.device_name(device)))
    return {
        "metric": "finetune_train_images_per_sec_per_chip",
        "value": round(args.batch / dt, 2),
        "unit": "images/sec/chip",
        "ms_per_step": round(dt * 1e3, 2),
        "batch": args.batch,
        "hw": args.hw,
        "mfu": None if share is None else round(share, 4),
        "model_flops_per_step": flops,
        "device": bm.card_line(device),
        "peak_device_mib": bm.peak_mib(device),
    }


def main(argv=None) -> int:
    result = run(bm.model_config("config_finetune.py"), "cuda", get_args(argv))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
