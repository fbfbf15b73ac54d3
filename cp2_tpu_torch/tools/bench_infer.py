"""Serving-path throughput: segmentation inference on an NVIDIA card.

Twin of ``tools/bench_infer.py`` with its flags and printed lines: the
``EncoderDecoder`` inference of ``train/inference.py`` in both modes, on
``config_finetune.py`` at bfloat16 with random weights (seed 0) and 2
classes (the serving default, binary polyp):

  whole : one forward at the native resolution (finetune/eval default)
  slide : overlapping windows (``--slide-crop``, ``--slide-stride``)

on a float32 batch drawn from ``np.random.RandomState(0)``, under
``torch.no_grad``.  It prints each mode's ms per batch and images/s, then
one JSON line with both, the card's name and power limit, and the peak
device memory; an earlier ``LAUNCHES`` line gives the dense-loss kernels'
launches beside the inference calls run.

    python -m cp2_tpu_torch.tools.bench_infer [--hw 352] [--batch 8] [--steps 30]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from cp2_tpu_torch.parallel import resolve_device
from cp2_tpu_torch.utils import benchmarking as bm


def get_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--hw", type=int, default=352,
                    help="input resolution (352 = polyp finetune)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--slide-crop", type=int, default=256)
    ap.add_argument("--slide-stride", type=int, default=170)
    return ap.parse_args(argv)


def run(model_cfg: dict, device, args) -> dict:
    """Both modes on ``device``; prints their lines and returns the JSON
    line's dict."""
    from cp2_tpu_torch.ops import dense_loss
    from cp2_tpu_torch.train.inference import init_segmentor, slide_inference, whole_inference

    device = resolve_device(device)
    bm.reset_peak(device)
    dense_loss.reset_launch_counts()
    # num_classes is assigned by the finetune entry per dataset; the serving
    # default is binary polyp
    num_classes = model_cfg["decode_head"].get("num_classes") or 2
    model = init_segmentor(model_cfg, num_classes=num_classes, dtype=torch.bfloat16,
                           device=device)
    r = np.random.RandomState(0)
    img = torch.from_numpy(r.rand(args.batch, args.hw, args.hw, 3).astype(np.float32)).to(device)
    result = {"metric": "inference_images_per_sec", "batch": args.batch, "hw": args.hw}
    forwards = []

    def time_mode(label, key, fn):
        fn = bm.Counted(fn)
        forwards.append(fn)
        with torch.no_grad():
            out = fn()
            dt = bm.seconds(fn, args.steps, device) / args.steps
        print(f"  {label}: {dt * 1e3:7.2f} ms/batch  {args.batch / dt:8.1f} img/s  "
              f"logits {tuple(out.shape)}", flush=True)
        result.update({f"{key}_ms": round(dt * 1e3, 3),
                       f"{key}_images_per_sec": round(args.batch / dt, 2)})

    print(f"inference bench: batch {args.batch} @ {args.hw}^2 bf16, {device.type}", flush=True)
    time_mode("whole", "whole", lambda: whole_inference(model, img))
    crop, stride = (args.slide_crop,) * 2, (args.slide_stride,) * 2
    time_mode(f"slide {args.slide_crop}/{args.slide_stride}", "slide",
              lambda: slide_inference(model, img, crop_size=crop, stride=stride,
                                      num_classes=num_classes))
    bm.print_launches(sum(fn.calls for fn in forwards))
    result.update(device=bm.card_line(device), peak_device_mib=bm.peak_mib(device))
    return result


def main(argv=None) -> int:
    print(json.dumps(run(bm.model_config("config_finetune.py"), "cuda", get_args(argv))),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
