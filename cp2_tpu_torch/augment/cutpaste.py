"""CutPaste defect synthesis on the device, batched.

Port of ``cp2_tpu/augment/cutpaste.py``: a random patch is cut from each
image and pasted elsewhere (REGULAR: axis-aligned; SCAR: thin, rotated),
optionally into a second "mirror" image as well (``MirrorVariant.OUTPUT``),
with a per-pixel class mask.

As in the JAX package, the paste runs in the inverse direction: for every
output pixel, its offset from the paste centre is rotated back into the
patch frame, tested against the half-extent box, and the source pixel is
gathered (truncated toward zero, then clipped).  Each later patch reads the
image that the earlier patches pasted into; the mask is the elementwise
maximum over patches.

Sampling and applying are split, as in ``functional``: ``sample_cutpaste``
draws every parameter of a batch from one ``torch.Generator`` (the class,
the patch count and each patch's geometry, with the rotation's cosine and
sine), and ``apply_cutpaste`` is deterministic given them.  The apply does
only elementwise multiplies, adds and compares on the parameters it is
given, so the card and the CPU paste the same pixels: a cosine computed on
each device could differ by an ulp and move a pixel at the patch's edge.

Class sampling follows the JAX package: per image, from [0.1, 0.45, 0.45]
for 3 classes or [0.1, 0.9] for 2.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from cp2_tpu_torch.parallel import current_layout, take_rows


@dataclass(frozen=True)
class CutPasteConfig:
    num_classes: int = 3            # NONE + REGULAR + SCAR (or 2: NONE + REGULAR)
    max_num_patches: int = 1
    min_area_scale: float = 0.02
    max_area_scale: float = 0.15
    min_aspect_ratio: float = 1 / 3
    max_aspect_ratio: float = 4 / 3
    min_rotation: float = 0.0       # degrees (SCAR only)
    max_rotation: float = 0.0


def class_probabilities(num_classes: int) -> Tuple[float, ...]:
    """The class law of ``cutpaste`` (``cutpaste.py:130-133``)."""
    return (0.1, 0.45, 0.45) if num_classes == 3 else (0.1, 0.9)


class CutPasteParams(NamedTuple):
    """One batch's draws: N images, P = ``max_num_patches`` patch slots.

    Geometry is in pixels, float32, (N, P); ``half_h``/``half_w`` are the
    patch's half extents in its own frame, ``cos``/``sin`` its rotation.
    """

    target: torch.Tensor  # (N,) int64, the image's class
    active: torch.Tensor  # (N, P) bool, slot i pastes (i == 0 or i <= extra)
    src_cy: torch.Tensor
    src_cx: torch.Tensor
    half_h: torch.Tensor
    half_w: torch.Tensor
    dst_cy: torch.Tensor
    dst_cx: torch.Tensor
    cos: torch.Tensor
    sin: torch.Tensor


def sample_cutpaste(generator: torch.Generator, n: int, hw: Tuple[int, int],
                    cfg: CutPasteConfig) -> CutPasteParams:
    """Draw the parameters of ``n`` images of ``hw`` on ``generator``'s
    device, by the laws of ``cutpaste`` and ``_sample_patch``
    (``cutpaste.py:42-84,129-137``): REGULAR area in [min, max] and aspect
    in [min_ar, max_ar], no rotation; SCAR area in [min, max/2], aspect in
    [3, 6] and a rotation in [min_rotation, max_rotation] degrees; the
    rotated box's half extents keep the paste inside the frame.  ``n`` is
    this rank's row count; the draw covers the global batch, of which each
    rank keeps its rows (``parallel.take_rows``)."""
    dev = generator.device
    h, w = hw
    layout = current_layout()
    n = n * layout.world
    slots = max(cfg.max_num_patches, 1)

    def u(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    # the class: the first cumulative probability above a uniform draw
    cdf = torch.tensor(class_probabilities(cfg.num_classes), device=dev).cumsum(0)[:-1]
    target = (u(n)[:, None] >= cdf).sum(dim=1)
    extra = torch.randint(0, slots, (n,), generator=generator, device=dev)
    slot = torch.arange(cfg.max_num_patches, device=dev)
    active = (slot == 0) | (slot <= extra[:, None])

    shape = (n, cfg.max_num_patches)
    is_scar = (target == 2)[:, None].expand(shape)
    area_hi = torch.where(is_scar, cfg.max_area_scale * 0.5, cfg.max_area_scale)
    area = h * w * (cfg.min_area_scale + u(*shape) * (area_hi - cfg.min_area_scale))
    aspect_lo = torch.where(is_scar, 3.0, cfg.min_aspect_ratio)
    aspect_hi = torch.where(is_scar, 6.0, cfg.max_aspect_ratio)
    aspect = aspect_lo + u(*shape) * (aspect_hi - aspect_lo)
    ph = torch.sqrt(area / aspect)
    pw = ph * aspect
    ph = ph.clamp(1.0, h - 1.0)
    pw = pw.clamp(1.0, w - 1.0)
    degrees = cfg.min_rotation + u(*shape) * (cfg.max_rotation - cfg.min_rotation)
    theta = torch.where(is_scar, degrees * (math.pi / 180.0), 0.0)
    cos, sin = torch.cos(theta), torch.sin(theta)
    bh = (ph * cos.abs() + pw * sin.abs()) / 2.0
    bw = (pw * cos.abs() + ph * sin.abs()) / 2.0
    u_sy, u_sx, u_dy, u_dx = u(4, *shape)
    return take_rows(CutPasteParams(
        target=target, active=active,
        src_cy=ph / 2 + u_sy * (h - ph), src_cx=pw / 2 + u_sx * (w - pw),
        half_h=ph / 2, half_w=pw / 2,
        dst_cy=bh + u_dy * (h - 2 * bh).clamp_min(0.0),
        dst_cx=bw + u_dx * (w - 2 * bw).clamp_min(0.0),
        cos=cos, sin=sin), layout)


def apply_cutpaste(images: torch.Tensor, mirrors: Optional[torch.Tensor],
                   params: CutPasteParams):
    """Paste every active patch into ``images`` (N, H, W, C) and, when
    given, the same pixels into ``mirrors``; returns ``(images, mirrors or
    None, mask (N, H, W) int32, target (N,) int32)`` (``cutpaste.py:87-150``)."""
    n, h, w = images.shape[:3]
    dev = images.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    rows = torch.arange(n, device=dev)[:, None, None]
    target = params.target.to(torch.int32)
    mask = torch.zeros((n, h, w), dtype=torch.int32, device=dev)

    def at(v, i):
        return v[:, i, None, None]

    for i in range(params.active.shape[1]):
        dy = ys - at(params.dst_cy, i)
        dx = xs - at(params.dst_cx, i)
        cos, sin = at(params.cos, i), at(params.sin, i)
        # rotate the offset back into the (unrotated) patch frame
        py = cos * dy + sin * dx
        px = -sin * dy + cos * dx
        inside = (py.abs() <= at(params.half_h, i)) & (px.abs() <= at(params.half_w, i))
        sy = (at(params.src_cy, i) + py).to(torch.int32).clamp(0, h - 1)
        sx = (at(params.src_cx, i) + px).to(torch.int32).clamp(0, w - 1)
        patch = images[rows, sy.long(), sx.long()]
        value = torch.where(params.active[:, i], target, 0)[:, None, None]
        paste = inside & (value > 0)
        images = torch.where(paste[..., None], patch, images)
        if mirrors is not None:
            mirrors = torch.where(paste[..., None], patch, mirrors)
        mask = torch.maximum(mask, torch.where(paste, value, mask))
    return images, mirrors, mask, target


def cutpaste_batch(generator: torch.Generator, images: torch.Tensor,
                   mirror_images: Optional[torch.Tensor],
                   cfg: CutPasteConfig) -> Dict[str, torch.Tensor]:
    """Sample on ``generator`` and apply (``cutpaste.py:153-177``):
    ``image``, ``mask``, ``target``, and ``mirror`` when ``mirror_images``
    is given (the ``MirrorVariant.OUTPUT`` behaviour)."""
    params = sample_cutpaste(generator, images.shape[0], tuple(images.shape[1:3]), cfg)
    out, mirrors, mask, target = apply_cutpaste(images, mirror_images, params)
    batch = {"image": out, "mask": mask, "target": target}
    if mirrors is not None:
        batch["mirror"] = mirrors
    return batch
