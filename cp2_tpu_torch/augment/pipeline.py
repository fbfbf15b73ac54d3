"""The on-device augmentation pipelines, batched.

Port of ``cp2_tpu/augment/pipeline.py``: the CP2 pretrain pipeline (two
crops of the foreground, two erased backgrounds; ``AugmentConfig``,
``two_crop_augment_batch``, ``background_augment_batch``,
``pretrain_batch_augment``, lines 29-149 and 282-296) and the finetune and
eval pipelines, which co-augment images and masks
(``FinetuneAugmentConfig``, ``lemon_augment_config``,
``finetune_augment_batch``, ``eval_augment_batch``, lines 152-279).  Raw
uint8 frames are the only input: everything runs where the frames are.

Sampling and applying are split (see ``functional``): ``sample_*_params``
draws every parameter of a batch from one ``torch.Generator``, and
``apply_*_augment`` is deterministic given them; ``*_batch_augment`` /
``*_augment_batch`` is the two in turn.  With more than one process a
sampler draws for the global batch (``n`` rows on each of the W ranks) and
keeps this rank's rows (``parallel.take_rows``), so W processes augment as
one process augments the concatenated batch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from cp2_tpu_torch.augment import functional as F
from cp2_tpu_torch.parallel import current_layout, take_rows


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
    ``n`` is this rank's row count; the draw covers the global batch.
    """
    layout = current_layout()
    n = n * layout.world
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
    return take_rows(PretrainAugParams(view_a, view_b, bg0, bg1, erase0, erase1), layout)


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


# ---------------------------------------------------------------------------
# finetune and eval: image and mask co-augmented (``pipeline.py:152-279``)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FinetuneAugmentConfig:
    """Polyp finetune train-time augmentation (reference
    finetune_dataset.py:301-337).  The host already did SmallestMaxSize and
    the crop; the card does the flips (image and mask), colour jitter, grid
    distortion (image bilinear, mask nearest through one warp) and Gaussian
    noise."""

    hflip_p: float = 0.5
    vflip_p: float = 0.5
    jitter_p: float = 0.75
    brightness: Tuple[float, float] = (0.65, 1.35)
    contrast: Tuple[float, float] = (0.5, 1.5)
    saturation: Tuple[float, float] = (0.0, 1.0)
    hue: Tuple[float, float] = (-0.1, 0.1)
    noise_p: float = 0.5
    noise_var: Tuple[float, float] = (10.0, 50.0)  # on the 0..255 scale
    distort_p: float = 0.2
    distort_limit: float = 0.3
    jitter_random_order: bool = False  # see AugmentConfig
    # A.RandomBrightnessContrast (lemon only): img·alpha + beta with
    # alpha = 1 + U(bc_contrast), beta = U(bc_brightness)
    bc_p: float = 0.0
    bc_brightness: Tuple[float, float] = (0.0, 0.5)
    bc_contrast: Tuple[float, float] = (0.0, 0.5)


def lemon_augment_config() -> FinetuneAugmentConfig:
    """Lemon-defect train stack (reference finetune_dataset.py:349-367):
    flips, grid distortion p 0.2, brightness/contrast p 0.5, Gaussian
    noise; no colour jitter."""
    return FinetuneAugmentConfig(jitter_p=0.0, bc_p=0.5)


class BrightContrastParams(NamedTuple):
    alpha: torch.Tensor  # (N,)
    beta: torch.Tensor
    apply: torch.Tensor  # (N,) bool


class NoiseParams(NamedTuple):
    var: torch.Tensor  # (N,) on the 0..255 scale
    normal: torch.Tensor  # (N, H, W, C) standard normal draws
    apply: torch.Tensor  # (N,) bool


class FinetuneAugParams(NamedTuple):
    """Everything one finetune batch is drawn with; an op the config turns
    off has ``None``."""

    hflip: torch.Tensor  # (N,) bool
    vflip: torch.Tensor
    jitter: Optional[F.JitterParams]
    bc: Optional[BrightContrastParams]
    distort: Optional[F.GridParams]
    noise: NoiseParams


def sample_finetune_params(generator: torch.Generator, n: int, hw: Tuple[int, int],
                           cfg: FinetuneAugmentConfig, channels: int = 3) -> FinetuneAugParams:
    """Draw the parameters of one finetune batch of ``n`` images of ``hw``
    on ``generator``'s device, by the laws of ``pipeline.py:203-239``; ``n``
    is this rank's row count, and the draw (the noise field too) covers the
    global batch."""
    dev = generator.device
    layout = current_layout()
    n = n * layout.world
    order = 0
    if cfg.jitter_random_order:
        order = int(torch.randint(0, len(F.JITTER_ORDERS), (1,), generator=torch.Generator()
                                  .manual_seed(generator.initial_seed())))
    hflip = F.sample_gate(generator, n, cfg.hflip_p)
    vflip = F.sample_gate(generator, n, cfg.vflip_p)
    jitter = (F.sample_color_jitter(generator, n, cfg.brightness, cfg.contrast,
                                    cfg.saturation, cfg.hue, cfg.jitter_p, order)
              if cfg.jitter_p > 0 else None)
    bc = None
    if cfg.bc_p > 0:
        bc = BrightContrastParams(
            alpha=1.0 + F._uniform(generator, (n,), *cfg.bc_contrast, dev),
            beta=F._uniform(generator, (n,), *cfg.bc_brightness, dev),
            apply=F.sample_gate(generator, n, cfg.bc_p))
    distort = (F.sample_grid_distortion(generator, n, distort_limit=cfg.distort_limit,
                                        p=cfg.distort_p)
               if cfg.distort_p > 0 else None)
    noise = NoiseParams(
        var=F._uniform(generator, (n,), *cfg.noise_var, dev),
        normal=torch.randn((n, *hw, channels), generator=generator, device=dev),
        apply=F.sample_gate(generator, n, cfg.noise_p))
    return take_rows(FinetuneAugParams(hflip, vflip, jitter, bc, distort, noise), layout)


def apply_finetune_augment(images: torch.Tensor, masks: torch.Tensor,
                           params: FinetuneAugParams):
    """Co-augment an image batch (N, H, W, 3), uint8 or float in [0, 1], and
    its masks (N, H, W): flips, jitter, brightness/contrast, grid
    distortion, noise, in the JAX order.  Returns float32 images in
    [0, 1] and the masks."""
    img = _to_float(images)
    img, mask = F.flip_pair(img, masks, params.hflip, dim=2)
    img, mask = F.flip_pair(img, mask, params.vflip, dim=1)
    if params.jitter is not None:
        img = F.color_jitter(img, params.jitter)
    if params.bc is not None:
        bc = params.bc
        moved = torch.clamp(img * F._per_image(bc.alpha) + F._per_image(bc.beta), 0.0, 1.0)
        img = torch.where(F._per_image(bc.apply), moved, img)
    if params.distort is not None:
        img, mask = F.grid_distortion(img, mask, params.distort)
    noise = params.noise
    noisy = torch.clamp(img + noise.normal * F._per_image(torch.sqrt(noise.var)) / 255.0,
                        0.0, 1.0)
    img = torch.where(F._per_image(noise.apply), noisy, img)
    return img, mask


def finetune_augment_batch(generator: torch.Generator, images: torch.Tensor,
                           masks: torch.Tensor, cfg: FinetuneAugmentConfig):
    """Sample on ``generator`` and apply: the finetune train batch."""
    params = sample_finetune_params(generator, images.shape[0], tuple(images.shape[1:3]),
                                    cfg, images.shape[3])
    return apply_finetune_augment(images, masks, params)


class EvalAugParams(NamedTuple):
    """Val-time flips and grid distortion; ``None`` where the op is off."""

    hflip: Optional[torch.Tensor]
    vflip: Optional[torch.Tensor]
    distort: Optional[F.GridParams]


def sample_eval_params(generator: torch.Generator, n: int, *, hflip_p: float = 0.5,
                       vflip_p: float = 0.5, distort_p: float = 0.0,
                       distort_limit: float = 0.3) -> EvalAugParams:
    """The val batch's draws; ``n`` is this rank's row count, and the draw
    covers the global batch."""
    layout = current_layout()
    n = n * layout.world
    return take_rows(EvalAugParams(
        hflip=F.sample_gate(generator, n, hflip_p) if hflip_p > 0 else None,
        vflip=F.sample_gate(generator, n, vflip_p) if vflip_p > 0 else None,
        distort=(F.sample_grid_distortion(generator, n, distort_limit=distort_limit,
                                          p=distort_p) if distort_p > 0 else None)), layout)


def apply_eval_augment(images: torch.Tensor, masks: torch.Tensor, params: EvalAugParams):
    """The reference's stochastic val transforms (``pipeline.py:244-279``):
    polyp flips H and V, lemon flips H and distorts; float images in [0, 1]."""
    img, mask = images, masks
    if params.hflip is not None:
        img, mask = F.flip_pair(img, mask, params.hflip, dim=2)
    if params.vflip is not None:
        img, mask = F.flip_pair(img, mask, params.vflip, dim=1)
    if params.distort is not None:
        img, mask = F.grid_distortion(img, mask, params.distort)
    return img, mask


def eval_augment_batch(generator: torch.Generator, images: torch.Tensor, masks: torch.Tensor,
                       *, hflip_p: float = 0.5, vflip_p: float = 0.5, distort_p: float = 0.0,
                       distort_limit: float = 0.3):
    """Sample on ``generator`` and apply: the val batch."""
    params = sample_eval_params(generator, images.shape[0], hflip_p=hflip_p, vflip_p=vflip_p,
                                distort_p=distort_p, distort_limit=distort_limit)
    return apply_eval_augment(images, masks, params)
