"""Serving export: one-file inference artifacts via ``torch.export``.

Port of ``cp2_tpu/serving.py``.  It freezes the finetuned segmentor's whole
inference function — uint8 → /255 preprocess (the finetune eval
normalisation) → the segmentor in whole or slide mode → bilinear logit
resize → argmax class map — with its weights into one ``torch.export``
artifact.  A server loads it with ``torch.export.load(path).module()`` and
calls it without model code, config parsing or checkpoint surgery.  A
metadata JSON beside the artifact says what it takes and returns; its
``platforms`` names the device the program was exported on (its weights
live there).

Shapes are static, or with ``batch_size=None`` the batch dimension is
symbolic (whole mode only: slide mode's window grid is computed from
concrete shapes).  ``torch.export`` specialises sizes 0 and 1, so a
symbolic batch is traced at an example batch of 2 under ``Dim("b",
min=1)``.

CLI::

    python -m cp2_tpu_torch.serving --config cp2_tpu_torch/configs/config_finetune.py \\
        --checkpoint <run_dir/step> --out /tmp/polyp_352.pt2 --hw 352 --batch 8 --selftest

``main(argv, device="cuda")`` exports on the card; ``device="cpu"`` on the
CPU, as the tests do.
"""

from __future__ import annotations

import argparse
import io
import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from cp2_tpu_torch.train.inference import init_segmentor, slide_inference, whole_inference

META_SUFFIX = ".json"


class InferenceModule(torch.nn.Module):
    """The segmentor's inference function (``serving.py:54-90``): an
    (N, H, W, 3) image batch — raw pixels in [0, 255] with ``preprocess``,
    which bakes in the eval normalisation x/255 — to an (N, H, W) int32
    class map, or the float32 logits with ``return_logits``."""

    def __init__(self, model: torch.nn.Module, *, mode: str = "whole", num_classes: int = 2,
                 crop_size: Optional[Tuple[int, int]] = None,
                 stride: Optional[Tuple[int, int]] = None, preprocess: bool = True,
                 return_logits: bool = False):
        super().__init__()
        if mode not in ("whole", "slide"):
            raise ValueError(f"unknown inference mode: {mode!r}")
        self.model = model
        self.mode = mode
        self.num_classes = num_classes
        self.crop_size = crop_size
        self.stride = stride
        self.preprocess = preprocess
        self.return_logits = return_logits

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x = img.to(torch.float32)
        if self.preprocess:
            x = x / 255.0
        if self.mode == "whole":
            logits = whole_inference(self.model, x)
        else:
            logits = slide_inference(self.model, x, crop_size=self.crop_size,
                                     stride=self.stride, num_classes=self.num_classes)
        if self.return_logits:
            return logits
        return torch.argmax(logits, dim=-1).to(torch.int32)


def make_inference_fn(model: torch.nn.Module, *, mode: str = "whole", num_classes: int = 2,
                      crop_size: Optional[Tuple[int, int]] = None,
                      stride: Optional[Tuple[int, int]] = None, preprocess: bool = True,
                      return_logits: bool = False) -> InferenceModule:
    """The inference function over a built segmentor, as a module in eval
    mode."""
    return InferenceModule(model, mode=mode, num_classes=num_classes, crop_size=crop_size,
                           stride=stride, preprocess=preprocess,
                           return_logits=return_logits).eval()


def export_segmentor(
    config,
    checkpoint_path: Optional[str] = None,
    out_path: Optional[str] = None,
    *,
    img_hw: Tuple[int, int] = (352, 352),
    batch_size: Optional[int] = 8,
    input_dtype: torch.dtype = torch.uint8,
    mode: str = "whole",
    num_classes: int = 2,
    crop_size: Tuple[int, int] = (256, 256),
    stride: Tuple[int, int] = (170, 170),
    bf16: bool = True,
    return_logits: bool = False,
    device="cuda",
):
    """Export the segmentor's inference function (``serving.py:93-162``).

    ``config`` is a config file path or a model config dict;
    ``checkpoint_path`` one of the port's finetune checkpoints (a step
    directory) whose weights are embedded.  Writes the program to
    ``out_path`` (``torch.export.save``) and its metadata to ``out_path +
    ".json"``; returns ``(exported_program, meta)``.
    """
    if batch_size is None and mode != "whole":
        raise ValueError("symbolic batch (batch_size=None) requires mode='whole': "
                         "slide mode's window grid needs concrete shapes")
    device = torch.device(device)
    model = init_segmentor(config, checkpoint_path, num_classes=num_classes,
                           dtype=torch.bfloat16 if bf16 else None, device=device)
    model.requires_grad_(False)
    fn = make_inference_fn(model, mode=mode, num_classes=num_classes, crop_size=crop_size,
                           stride=stride, return_logits=return_logits)
    h, w = img_hw
    example = torch.zeros((batch_size or 2, h, w, 3), dtype=input_dtype, device=device)
    dynamic = None
    if batch_size is None:
        dynamic = {"img": {0: torch.export.Dim("b", min=1)}}
    exported = torch.export.export(fn, (example,), dynamic_shapes=dynamic)
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    blob = buf.getvalue()
    meta = {
        "mode": mode,
        "img_hw": list(img_hw),
        "batch_size": batch_size,
        "input_dtype": str(input_dtype).removeprefix("torch."),
        "num_classes": num_classes,
        "returns": "logits" if return_logits else "class_map",
        "preprocess": "x / 255 (raw [0,255] pixels in)",
        "bf16": bf16,
        "platforms": [device.type],
        "crop_size": list(crop_size) if mode == "slide" else None,
        "stride": list(stride) if mode == "slide" else None,
        "checkpoint": checkpoint_path,
        "bytes": len(blob),
    }
    if out_path:
        with open(out_path, "wb") as f:
            f.write(blob)
        with open(out_path + META_SUFFIX, "w") as f:
            json.dump(meta, f, indent=1)
    return exported, meta


def load_exported(path: str) -> torch.nn.Module:
    """Load a serving artifact; call the returned module on an image batch."""
    return torch.export.load(path).module()


def main(argv=None, device="cuda"):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint", default=None,
                   help="finetune checkpoint dir (<run>/<step>)")
    p.add_argument("--out", required=True, help="artifact output path")
    p.add_argument("--hw", type=int, default=352)
    p.add_argument("--batch", type=int, default=8,
                   help="0 exports a symbolic batch dimension (whole mode)")
    p.add_argument("--mode", choices=("whole", "slide"), default="whole")
    p.add_argument("--num_classes", type=int, default=2)
    p.add_argument("--slide-crop", type=int, default=256)
    p.add_argument("--slide-stride", type=int, default=170)
    p.add_argument("--f32", action="store_true",
                   help="compute in f32 instead of bf16")
    p.add_argument("--logits", action="store_true",
                   help="return float32 logits instead of the class map")
    p.add_argument("--selftest", action="store_true",
                   help="load the artifact and check it against the "
                        "live model on a random batch")
    args = p.parse_args(argv)

    crop = (args.slide_crop, args.slide_crop)
    stride = (args.slide_stride, args.slide_stride)
    _, meta = export_segmentor(
        args.config, args.checkpoint, args.out,
        img_hw=(args.hw, args.hw),
        batch_size=args.batch or None,
        mode=args.mode,
        num_classes=args.num_classes,
        crop_size=crop,
        stride=stride,
        bf16=not args.f32,
        return_logits=args.logits,
        device=device,
    )
    print(json.dumps(meta, indent=1))

    if args.selftest:
        model = init_segmentor(args.config, args.checkpoint, num_classes=args.num_classes,
                               dtype=None if args.f32 else torch.bfloat16, device=device)
        live = make_inference_fn(model, mode=args.mode, num_classes=args.num_classes,
                                 crop_size=crop, stride=stride, return_logits=args.logits)
        n = args.batch or 2
        x = torch.from_numpy(np.random.RandomState(0).randint(
            0, 256, (n, args.hw, args.hw, 3), np.uint8)).to(device)
        with torch.no_grad():
            got = load_exported(args.out)(x).cpu().numpy()
            want = live(x).cpu().numpy()
        if args.logits:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(got, want)
        print(f"selftest OK: artifact matches live model on "
              f"{tuple(x.shape)} {os.path.basename(args.out)}")
    return meta


if __name__ == "__main__":
    main()
