"""The CP2 pretrain augmentation: two crops of the foreground, two erased
backgrounds, batched on the device.

Port of ``AugmentConfig``, ``two_crop_augment_batch``,
``background_augment_batch`` and ``pretrain_batch_augment`` of
``cp2_tpu/augment/pipeline.py`` (lines 29-149, 282-296); the finetune and
eval pipelines wait for the finetune path.  Raw uint8 frames are the only
input: crops, photometric ops, id maps and the erase all run where the
frames are.

Sampling and applying are split (see ``functional``):
``sample_pretrain_params`` draws every parameter of a batch from one
``torch.Generator``, and ``apply_pretrain_augment`` is deterministic given
them; ``pretrain_batch_augment`` is the two in turn.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from cp2_tpu_torch.augment import functional as F


@dataclass(frozen=True)
class AugmentConfig:
    out_hw: Tuple[int, int] = (224, 224)
    crop_scale: Tuple[float, float] = (0.2, 1.0)
    crop_ratio: Tuple[float, float] = (3 / 4, 4 / 3)
    jitter_p: float = 0.8
    brightness: Tuple[float, float] = (0.6, 1.4)
    contrast: Tuple[float, float] = (0.6, 1.4)
    saturation: Tuple[float, float] = (0.6, 1.4)
    hue: Tuple[float, float] = (-0.1, 0.1)
    grayscale_p: float = 0.2
    blur_p: float = 0.5
    blur_sigma: Tuple[float, float] = (0.1, 2.0)
    flip_p: float = 0.5
    erase_scale: Tuple[float, float] = (0.5, 0.8)  # foreground_{min,max}
    erase_ratio: Tuple[float, float] = (0.8, 1.25)
    pixel_ids_stride: int = 1
    # one random jitter op order per batch and view (the reference shuffles
    # per call); off by default, as in the JAX package
    jitter_random_order: bool = False


class ViewParams(NamedTuple):
    """Everything one augmented view of a batch is drawn with."""

    crop: F.CropParams
    jitter: F.JitterParams
    gray: torch.Tensor  # (N,) bool
    blur: F.BlurParams


class PretrainAugParams(NamedTuple):
    view_a: ViewParams
    view_b: ViewParams
    bg0: ViewParams
    bg1: ViewParams
    erase0: F.EraseParams
    erase1: F.EraseParams


def _sample_view(generator, n, src_hw, cfg: AugmentConfig, order: int) -> ViewParams:
    crop = F.sample_resized_crop(generator, n, src_hw, cfg.crop_scale,
                                 cfg.crop_ratio, cfg.flip_p)
    jitter = F.sample_color_jitter(generator, n, cfg.brightness, cfg.contrast,
                                   cfg.saturation, cfg.hue, cfg.jitter_p, order)
    gray = F.sample_gate(generator, n, cfg.grayscale_p)
    blur = F.sample_gaussian_blur(generator, n, cfg.blur_sigma, cfg.blur_p)
    return ViewParams(crop, jitter, gray, blur)


def sample_pretrain_params(
    generator: torch.Generator,
    n: int,
    src_hw: Tuple[int, int],
    cfg: AugmentConfig,
) -> PretrainAugParams:
    """Draw the parameters of one pretrain batch of ``n`` frames of
    ``src_hw``, on ``generator``'s device.

    With ``cfg.jitter_random_order`` the four op orders (one per view of
    each stream) come from a CPU generator seeded with ``generator``'s
    seed, so that the host knows them without waiting on the device.
    Otherwise every view keeps the fixed order 0, as in the JAX package.
    """
    if cfg.jitter_random_order:
        orders = torch.randint(0, len(F.JITTER_ORDERS), (4,),
                               generator=torch.Generator().manual_seed(
                                   generator.initial_seed())).tolist()
    else:
        orders = [0, 0, 0, 0]
    view_a = _sample_view(generator, n, src_hw, cfg, orders[0])
    view_b = _sample_view(generator, n, src_hw, cfg, orders[1])
    bg0 = _sample_view(generator, n, src_hw, cfg, orders[2])
    bg1 = _sample_view(generator, n, src_hw, cfg, orders[3])
    erase0 = F.sample_random_erase(generator, n, cfg.out_hw, cfg.erase_scale,
                                   cfg.erase_ratio)
    erase1 = F.sample_random_erase(generator, n, cfg.out_hw, cfg.erase_scale,
                                   cfg.erase_ratio)
    return PretrainAugParams(view_a, view_b, bg0, bg1, erase0, erase1)


def _to_float(img: torch.Tensor) -> torch.Tensor:
    if img.dtype == torch.uint8:
        return img.to(torch.float32) / 255.0
    return img.to(torch.float32)


def _view(img: torch.Tensor, p: ViewParams, cfg: AugmentConfig) -> torch.Tensor:
    """Crop-resize, jitter, grayscale, blur (``pipeline.py:52-69``)."""
    view = F.crop_resize_bilinear(img, p.crop, cfg.out_hw)
    view = F.color_jitter(view, p.jitter)
    view = F.to_grayscale(view, p.gray)
    return F.gaussian_blur(view, p.blur)


def two_crop_augment_batch(images: torch.Tensor, region_maps: Optional[torch.Tensor],
                           view_a: ViewParams, view_b: ViewParams,
                           cfg: AugmentConfig) -> Dict[str, torch.Tensor]:
    """Two augmented views of each frame with warped id maps
    (``pipeline.py:85-126``): img_a/img_b (N, H, W, 3) float32,
    pixel_ids_a/b and region_ids_a/b (N, H, W) int32."""
    img = _to_float(images)
    src_hw = tuple(images.shape[1:3])
    out = {}
    for name, p in (("a", view_a), ("b", view_b)):
        out[f"img_{name}"] = _view(img, p, cfg)
        ids = F.pixel_ids_from_crop(p.crop, cfg.out_hw, src_hw, cfg.pixel_ids_stride)
        out[f"pixel_ids_{name}"] = ids
        out[f"region_ids_{name}"] = (
            ids if region_maps is None
            else F.warp_id_map(region_maps, p.crop, cfg.out_hw).to(torch.int32))
    return out


def background_augment_batch(images: torch.Tensor, view: ViewParams,
                             erase: F.EraseParams, cfg: AugmentConfig) -> torch.Tensor:
    """Crop, photometric ops and an erase to zero (``pipeline.py:129-149``)."""
    return F.random_erase(_view(_to_float(images), view, cfg), erase, 0.0)


def apply_pretrain_augment(raw: Dict[str, torch.Tensor], params: PretrainAugParams,
                           cfg: AugmentConfig) -> Dict[str, torch.Tensor]:
    """The CP2 batch from raw frames ``fg``, ``bg0``, ``bg1`` (N, H, W, 3)
    and optional ``region_maps`` (N, H, W) (``pipeline.py:282-296``)."""
    batch = two_crop_augment_batch(raw["fg"], raw.get("region_maps"),
                                   params.view_a, params.view_b, cfg)
    batch["bg0"] = background_augment_batch(raw["bg0"], params.bg0, params.erase0, cfg)
    batch["bg1"] = background_augment_batch(raw["bg1"], params.bg1, params.erase1, cfg)
    return batch


def pretrain_batch_augment(generator: torch.Generator, raw: Dict[str, torch.Tensor],
                           cfg: AugmentConfig) -> Dict[str, torch.Tensor]:
    """Sample on ``generator`` and apply: the full CP2 pretrain batch.  The
    three streams share one frame size, as the CLI's loaders give them."""
    fg = raw["fg"]
    if raw["bg0"].shape != fg.shape or raw["bg1"].shape != fg.shape:
        raise ValueError(f"frames of one size expected: fg {tuple(fg.shape)}, "
                         f"bg0 {tuple(raw['bg0'].shape)}, bg1 {tuple(raw['bg1'].shape)}")
    params = sample_pretrain_params(generator, fg.shape[0], tuple(fg.shape[1:3]), cfg)
    return apply_pretrain_augment(raw, params, cfg)
