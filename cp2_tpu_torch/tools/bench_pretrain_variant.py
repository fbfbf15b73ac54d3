"""Pretrain-step throughput of the SSL variants on an NVIDIA card.

Twin of ``tools/bench_pretrain_variant.py`` with its flags: the pretrain
CLI's step (on-device two-crop augmentation, both encoders forward and
backward, EMA and queue updates) for ``--variant`` on ``--backbone``, a
bfloat16 model, SGD at 1e-3, from raw uint8 frames of (hw + 32)² drawn
from ``np.random.RandomState(0)``.  CP2, PROPOSED and PROPOSED_V2 run
``config_pretrain.py``, MOCO, BYOL and DENSECL ``config_moco.py``; the
U-Net backbones take the CP2 family only, as the reference's builders
do.  ``BENCH_METRICS_LEVEL`` sets the step's metrics.

    python -m cp2_tpu_torch.tools.bench_pretrain_variant --variant DENSECL

It counts the first step's FLOPs (``utils/flops.py``) and times
``--steps`` steps after ``--warmup``; the JSON line has the JAX tool's
keys, ``mfu`` over the card's dense bf16 peak, and the card's name and
power limit.  An earlier ``LAUNCHES`` line gives the dense-loss kernels'
launches beside the steps run.

``state_and_step`` builds the step for ``cp2_tpu_torch.bench``,
``bench_metrics`` and ``profile_step`` too, and ``step_flops`` counts it
from its configuration alone (meta device), which the count of the first
step run must equal.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from cp2_tpu_torch.parallel import resolve_device
from cp2_tpu_torch.utils import benchmarking as bm

VARIANTS = ("CP2", "PROPOSED", "PROPOSED_V2", "DENSECL", "MOCO", "BYOL")
DENSE_FAMILY = ("CP2", "PROPOSED", "PROPOSED_V2")


def get_args(argv=None):
    from cp2_tpu_torch.types import BackboneType, PretrainType

    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", default="DENSECL",
                    choices=[t.name for t in PretrainType if t.name in VARIANTS])
    ap.add_argument("--backbone", default="DEEPLABV3",
                    choices=[b.name for b in BackboneType])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--hw", type=int, default=224)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--warmup", type=int, default=5)
    args = ap.parse_args(argv)
    if args.backbone != "DEEPLABV3" and args.variant not in DENSE_FAMILY:
        # MoCo/BYOL/DenseCL read backbone(...)[3] and a projector sized for
        # the segmentor's ResNet (reference builder.py:1015-1016)
        ap.error(f"--backbone {args.backbone} supports only the CP2/PROPOSED "
                 f"dense family, not {args.variant}")
    return args


def config_name(variant: str) -> str:
    """The reference scripts' config for a variant."""
    return "config_pretrain.py" if variant in DENSE_FAMILY else "config_moco.py"


def _model(model_cfg: dict, hp, bt, hw: int):
    from cp2_tpu_torch.ssl import SSLEncoder

    return SSLEncoder(model_cfg, pretrain_type=hp.pretrain_type, backbone_type=bt, dim=hp.dim,
                      unet_truncated_dec_blocks=hp.unet_truncated_dec_blocks,
                      dtype=torch.bfloat16, img_hw=(hw, hw))


def _step(model_cfg: dict, hp, bt, hw: int, *, metrics_level: int, epoch_scalars: bool,
          augment: bool):
    from cp2_tpu_torch.augment import AugmentConfig, pretrain_batch_augment
    from cp2_tpu_torch.ssl.train_step import (
        backbone_output_stride_of, dense_output_stride_of, make_pretrain_step)

    aug_cfg = AugmentConfig(out_hw=(hw, hw))
    blocks = hp.unet_truncated_dec_blocks
    return make_pretrain_step(
        hp, dense_output_stride_of(model_cfg, bt, blocks),
        backbone_output_stride_of(model_cfg, bt, blocks), metrics_level=metrics_level,
        epoch_scalars=epoch_scalars,
        augment_fn=(lambda gen, raw: pretrain_batch_augment(gen, raw, aug_cfg))
        if augment else None)


def state_and_step(model_cfg: dict, device, variant: str, backbone: str, hw: int, *,
                   metrics_level: int = 0, epoch_scalars: bool = False, augment: bool = True):
    """``(state, step)`` of ``variant`` on ``backbone`` on ``device``: a
    bfloat16 model from seed 0, SGD at 1e-3, and the pretrain CLI's step,
    with the on-device augmentation of raw uint8 frames unless ``augment``
    is false (then it takes ``apply_pretrain_augment``'s batch); ``step``
    counts its calls (``utils/benchmarking.py::Counted``)."""
    from cp2_tpu_torch.ssl import SSLHyperParams, create_pretrain_state
    from cp2_tpu_torch.ssl.train_step import make_optimizer
    from cp2_tpu_torch.types import BackboneType, PretrainType

    hp, bt = SSLHyperParams.for_variant(PretrainType[variant]), BackboneType[backbone]
    state = create_pretrain_state(_model(model_cfg, hp, bt, hw), make_optimizer("sgd", 1e-3),
                                  hp, seed=0, device=device)
    return state, bm.Counted(_step(model_cfg, hp, bt, hw, metrics_level=metrics_level,
                                   epoch_scalars=epoch_scalars, augment=augment))


def build(model_cfg: dict, device, variant: str, backbone: str, batch: int, hw: int, *,
          metrics_level: int = 0):
    """``(call, step)``: ``call()`` runs one step of ``state_and_step`` on
    raw uint8 frames of (hw + 32)² drawn from ``np.random.RandomState(0)``
    and returns its loss; ``step.calls`` counts the steps run."""
    state, step = state_and_step(model_cfg, device, variant, backbone, hw,
                                 metrics_level=metrics_level)
    base = hw + 32
    r = np.random.RandomState(0)
    raw = {k: torch.from_numpy((r.rand(batch, base, base, 3) * 255).astype(np.uint8))
           .to(device) for k in ("fg", "bg0", "bg1")}
    return lambda: step(state, raw, 42)[1]["loss"], step


def pretrain_batch_shapes(batch: int, hw: int) -> dict:
    """A pre-augmented pretrain batch on the meta device (the keys
    ``apply_pretrain_augment`` gives) of ``batch`` NHWC images of ``hw``²."""
    img = dict(size=(batch, hw, hw, 3), dtype=torch.float32, device="meta")
    ids = dict(size=(batch, hw, hw), dtype=torch.int32, device="meta")
    out = {k: torch.empty(**img) for k in ("img_a", "img_b", "bg0", "bg1")}
    out.update({k: torch.empty(**ids) for k in
                ("pixel_ids_a", "pixel_ids_b", "region_ids_a", "region_ids_b")})
    return out


def step_flops(model_cfg: dict, variant: str, backbone: str, batch: int, hw: int, *,
               augment: bool = True, metrics_level: int = 0,
               epoch_scalars: bool = False) -> int:
    """FLOPs of one step of ``state_and_step`` at ``batch`` x ``hw``² from
    the configuration alone (``utils/flops.py``'s count, on the meta device
    with shapes only; the augmentation's parameters are drawn on the CPU):
    with ``augment`` the step starts from raw uint8 frames of (hw + 32)²
    and the augmentation is counted too."""
    import copy

    from cp2_tpu_torch.augment import AugmentConfig
    from cp2_tpu_torch.augment.pipeline import apply_pretrain_augment, sample_pretrain_params
    from cp2_tpu_torch.ssl import SSLHyperParams
    from cp2_tpu_torch.ssl.state import PretrainState
    from cp2_tpu_torch.ssl.train_step import make_optimizer
    from cp2_tpu_torch.types import BackboneType, PretrainType
    from cp2_tpu_torch.utils.flops import flop_counter

    hp, bt = SSLHyperParams.for_variant(PretrainType[variant]), BackboneType[backbone]
    with torch.device("meta"):
        model = _model(model_cfg, hp, bt, hw).train()
        ema_model = copy.deepcopy(model).requires_grad_(False)
        queues = [torch.empty((hp.queue_len, hp.dim)) for _ in range(2)]
    state = PretrainState(step=0, model=model, ema_model=ema_model,
                          optimizer=make_optimizer("sgd", 1e-3)(model.parameters()),
                          queue=queues[0], queue_ptr=0, queue2=queues[1], queue2_ptr=0)
    step = _step(model_cfg, hp, bt, hw, metrics_level=metrics_level,
                 epoch_scalars=epoch_scalars, augment=False)
    with flop_counter() as counter:
        if augment:
            base = hw + 32
            cfg = AugmentConfig(out_hw=(hw, hw))
            params = sample_pretrain_params(torch.Generator().manual_seed(0), batch,
                                            (base, base), cfg)
            raw = {k: torch.empty((batch, base, base, 3), dtype=torch.uint8, device="meta")
                   for k in ("fg", "bg0", "bg1")}
            batch_ = apply_pretrain_augment(raw, bm.to_meta(params), cfg)
        else:
            batch_ = pretrain_batch_shapes(batch, hw)
        step(state, batch_)
    return counter.get_total_flops()


def run(model_cfg: dict, device, args, *, metrics_level: int = 0) -> dict:
    """The benchmark of ``args`` on ``device``; returns the JSON line's dict."""
    from cp2_tpu_torch.ops import dense_loss
    from cp2_tpu_torch.types import BackboneType
    from cp2_tpu_torch.utils.flops import mfu, peak_bf16_flops

    device = resolve_device(device)
    bt = BackboneType[args.backbone]
    bm.reset_peak(device)
    dense_loss.reset_launch_counts()
    call, step = build(model_cfg, device, args.variant, args.backbone, args.batch, args.hw,
                       metrics_level=metrics_level)
    flops, dt, _ = bm.count_and_time(call, warmup=args.warmup, steps=args.steps,
                                     device=device)
    dt /= args.steps
    bm.print_launches(step.calls)
    share = mfu(flops, 1, dt, peak_bf16_flops(bm.device_name(device)))
    suffix = "" if bt == BackboneType.DEEPLABV3 else "_" + bt.name.lower()
    return {
        "metric": f"{args.variant.lower()}{suffix}_pretrain_images_per_sec_per_chip",
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
    args = get_args(argv)
    result = run(bm.model_config(config_name(args.variant)), "cuda", args,
                 metrics_level=int(os.environ.get("BENCH_METRICS_LEVEL", "0")))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
