"""Inference utilities: whole-image and sliding-window segmentation.

Port of ``cp2_tpu/train/inference.py`` (the reference's mmseg inference
surface: ``encoder_decoder.py:181-243`` slide/whole modes,
``apis/inference.py:11-99`` init/inference helpers).  Images are NHWC
float32 batches; the segmentor gets a contiguous NCHW tensor made
explicitly, as ``seg_forward`` gives it, and the logits come back NHWC in
float32, resized by the port's ``ops/resize.py`` (JAX's antialiased linear
resize).  The sliding window clamps its windows to the border, sums each
window's logits into a canvas and divides by the visit counts, as mmseg
does.

The functions run the model as it is given, so it should be in eval mode
(``init_segmentor`` returns it so); call them under ``torch.no_grad()``,
as ``inference_segmentor`` does (``torch.export`` traces them as they are).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from cp2_tpu_torch.ops.resize import resize_bilinear


def _logits(model: torch.nn.Module, img: torch.Tensor, out_hw) -> torch.Tensor:
    """NHWC float32 logits of an NHWC batch, resized to ``out_hw``."""
    out = model(img.permute(0, 3, 1, 2).contiguous())
    return resize_bilinear(out.float().permute(0, 2, 3, 1), out_hw)


def whole_inference(model: torch.nn.Module, img: torch.Tensor,
                    out_hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Single forward; logits resized to ``out_hw`` (default: the input's
    size)."""
    return _logits(model, img, tuple(out_hw or img.shape[1:3]))


def slide_windows(hw: Tuple[int, int], crop_size: Tuple[int, int],
                  stride: Tuple[int, int]) -> List[Tuple[int, int]]:
    """The (y0, x0) corner of every window: a grid of ``ceil((size - crop)
    / stride) + 1`` per axis, the last window clamped to the border."""
    (h, w), (ch, cw), (sh, sw) = hw, crop_size, stride
    grid_h = max(0, -(-(h - ch) // sh)) + 1
    grid_w = max(0, -(-(w - cw) // sw)) + 1
    return [(min(gy * sh, h - ch), min(gx * sw, w - cw))
            for gy in range(grid_h) for gx in range(grid_w)]


def slide_counts(hw: Tuple[int, int], crop_size: Tuple[int, int],
                 stride: Tuple[int, int], device=None) -> torch.Tensor:
    """(1, H, W, 1) float32: how many windows cover each pixel."""
    counts = torch.zeros((1, *hw, 1), dtype=torch.float32, device=device)
    ch, cw = crop_size
    for y0, x0 in slide_windows(hw, crop_size, stride):
        counts[:, y0:y0 + ch, x0:x0 + cw] += 1.0
    return counts


def slide_inference(model: torch.nn.Module, img: torch.Tensor, crop_size: Tuple[int, int],
                    stride: Tuple[int, int], num_classes: int) -> torch.Tensor:
    """Sliding-window inference with overlap averaging
    (``inference.py:30-73``): each window's logits are resized to the
    window, summed into a canvas, and the canvas divided by the counts."""
    n, h, w, _ = img.shape
    ch, cw = crop_size
    canvas = torch.zeros((n, h, w, num_classes), dtype=torch.float32, device=img.device)
    for y0, x0 in slide_windows((h, w), crop_size, stride):
        window = img[:, y0:y0 + ch, x0:x0 + cw]
        canvas[:, y0:y0 + ch, x0:x0 + cw] += _logits(model, window, (ch, cw))
    counts = slide_counts((h, w), crop_size, stride, img.device)
    return canvas / counts.clamp_min(1.0)


def init_segmentor(config, checkpoint_path: Optional[str] = None,
                   num_classes: Optional[int] = None, dtype: Optional[torch.dtype] = None,
                   device="cuda") -> torch.nn.Module:
    """Build a segmentor from a config and a checkpoint, in eval mode on
    ``device`` (mmseg ``init_segmentor``, ``inference.py:76-110``).

    ``config`` is a config file path, a ``Config`` or a model config dict;
    ``dtype`` overrides the model's compute dtype (bfloat16 for serving).
    ``checkpoint_path`` is one of the port's checkpoints (a step directory
    holding ``state.pt`` and ``meta.json``; its ``model`` is loaded whole);
    an orbax directory of the JAX package is refused.  Without one the
    weights are random, from a seed-0 generator.  The default device is the
    card: with none present this raises.
    """
    from cp2_tpu_torch.config import Config
    from cp2_tpu_torch.models import build_segmentor
    from cp2_tpu_torch.models.layers import init_flax_like_
    from cp2_tpu_torch.train.finetune import load_any_checkpoint

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    cfg = Config.fromfile(config) if isinstance(config, str) else config
    model_cfg = dict(cfg.model if hasattr(cfg, "model") else cfg)
    if "model" in model_cfg and "type" not in model_cfg:
        model_cfg = dict(model_cfg["model"])
    if num_classes is not None:
        model_cfg["decode_head"] = dict(model_cfg["decode_head"], num_classes=num_classes)
    if dtype is not None:
        model_cfg["dtype"] = dtype
    model = build_segmentor(model_cfg)
    init_flax_like_(model, torch.Generator().manual_seed(0))
    if checkpoint_path:
        state_dict, _ = load_any_checkpoint(checkpoint_path)
        model.load_state_dict(state_dict)
    return model.to(device).eval()


def inference_segmentor(model: torch.nn.Module, img: torch.Tensor, *, mode: str = "whole",
                        **kwargs) -> torch.Tensor:
    """Predicted class map (N, H, W) for a preprocessed NHWC image batch."""
    with torch.no_grad():
        if mode == "whole":
            logits = whole_inference(model, img)
        elif mode == "slide":
            logits = slide_inference(model, img, **kwargs)
        else:
            raise ValueError(mode)
    return torch.argmax(logits, dim=-1)
