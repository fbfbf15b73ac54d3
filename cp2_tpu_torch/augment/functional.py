"""Batched augmentation primitives of the pretrain and finetune paths.

Port of ``cp2_tpu/augment/functional.py``: the pretrain ops (lines 24-353
and 458-486) and the finetune geometry, image/mask flips and
``grid_distortion`` (356-455).  The JAX ops take one image and a PRNG key
and run under ``vmap``; here every op
takes the whole batch, images (N, H, W, 3) float32 in [0, 1], with its
per-image parameters as (N,) tensors, and each op is split in two:

* ``sample_*(generator, n, ...)`` draws the parameters from an explicit
  ``torch.Generator`` on the generator's device, in one batched draw per
  law, so nothing reaches the host;
* the op itself applies given parameters and is deterministic, which is
  what the tests hold against the JAX op on the JAX draws.

torch's generator cannot replay JAX's threefry draws, so the samplers
follow the JAX laws (same ranges, gates, first-valid-attempt rule) without
reproducing their bits.
"""

from __future__ import annotations

import itertools
import math
from typing import NamedTuple, Optional, Tuple

import torch

# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


class CropParams(NamedTuple):
    """Crop boxes in source pixels and horizontal flips, one per image."""

    y0: torch.Tensor  # (N,) float32
    x0: torch.Tensor
    h: torch.Tensor
    w: torch.Tensor
    flip: torch.Tensor  # (N,) bool


def _uniform(generator, shape, lo, hi, device):
    """``lo + (hi - lo) * U[0, 1)``, the law of ``jax.random.uniform``."""
    u = torch.rand(shape, generator=generator, device=device)
    return lo + (hi - lo) * u


def sample_resized_crop(
    generator: torch.Generator,
    n: int,
    src_hw: Tuple[int, int],
    scale: Tuple[float, float] = (0.2, 1.0),
    ratio: Tuple[float, float] = (3 / 4, 4 / 3),
    flip_p: float = 0.5,
    attempts: int = 10,
) -> CropParams:
    """torchvision RandomResizedCrop's law (``functional.py:34-88``).

    ``attempts`` (area, log-aspect) candidates per image; the first that
    fits is taken, else a centre crop clamped to the ratio range.
    """
    dev = generator.device
    height, width = src_hw
    area = float(height * width)
    target_area = area * _uniform(generator, (n, attempts), scale[0], scale[1], dev)
    log_ratio = _uniform(generator, (n, attempts), math.log(ratio[0]),
                         math.log(ratio[1]), dev)
    aspect = torch.exp(log_ratio)
    ws = torch.sqrt(target_area * aspect)
    hs = torch.sqrt(target_area / aspect)
    valid = (ws <= width) & (hs <= height)
    # argmax over an int tensor returns the first maximum: the first valid
    # attempt, or 0 when none is (then the fallback below is taken)
    first = torch.argmax(valid.to(torch.int32), dim=1, keepdim=True)
    any_valid = valid.any(dim=1)
    w_sel = ws.gather(1, first)[:, 0]
    h_sel = hs.gather(1, first)[:, 0]

    in_ratio = width / height
    if in_ratio < ratio[0]:
        fb_w, fb_h = float(width), width / ratio[0]
    elif in_ratio > ratio[1]:
        fb_w, fb_h = height * ratio[1], float(height)
    else:
        fb_w, fb_h = float(width), float(height)
    w = torch.where(any_valid, w_sel, torch.full_like(w_sel, fb_w))
    h = torch.where(any_valid, h_sel, torch.full_like(h_sel, fb_h))

    u_y = torch.rand(n, generator=generator, device=dev)
    u_x = torch.rand(n, generator=generator, device=dev)
    y0 = torch.where(any_valid, u_y * (height - h), (height - h) / 2.0)
    x0 = torch.where(any_valid, u_x * (width - w), (width - w) / 2.0)
    flip = torch.rand(n, generator=generator, device=dev) < flip_p
    return CropParams(y0=y0, x0=x0, h=h, w=w, flip=flip)


def _resample_matrix(in_size: int, out_size: int, scale: torch.Tensor,
                     translation: torch.Tensor) -> torch.Tensor:
    """(N, out, in) weights of ``jax.image.scale_and_translate`` along one
    axis, linear kernel, no antialiasing (its ``compute_weight_mat``).

    Triangle weights around each sample position, normalised over the taps
    in range, and zero where the sample lies outside ``[-0.5, in - 0.5]``.
    """
    dev = scale.device
    inv_scale = 1.0 / scale[:, None]
    sample_f = ((torch.arange(out_size, device=dev, dtype=torch.float32) + 0.5)
                * inv_scale - translation[:, None] * inv_scale - 0.5)  # (N, out)
    src = torch.arange(in_size, device=dev, dtype=torch.float32)
    weights = torch.clamp(1.0 - (sample_f[:, :, None] - src).abs(), min=0.0)
    total = weights.sum(dim=2, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, :, None], weights, 0.0)


def crop_resize_bilinear(img: torch.Tensor, crop: CropParams,
                         out_hw: Tuple[int, int]) -> torch.Tensor:
    """Crop and resize in one bilinear resampling (``functional.py:91-126``).

    The JAX op is ``jax.image.scale_and_translate`` (linear, no
    antialiasing) with the flip folded in as a negative x scale; here the
    same per-image (out, src) weight matrices are built and applied as two
    batched products, rows then columns.
    """
    out_h, out_w = out_hw
    src_h, src_w = img.shape[1], img.shape[2]
    sy = out_h / crop.h
    sx = out_w / crop.w
    scale_x = torch.where(crop.flip, -sx, sx)
    ty = -crop.y0 * out_h / crop.h
    tx = torch.where(crop.flip, (crop.x0 + crop.w) * sx, -crop.x0 * sx)
    wy = _resample_matrix(src_h, out_h, sy, ty)  # (N, out_h, src_h)
    wx = _resample_matrix(src_w, out_w, scale_x, tx)  # (N, out_w, src_w)
    rows = torch.einsum("noh,nhwc->nowc", wy, img)
    return torch.einsum("npw,nowc->nopc", wx, rows)


def crop_source_indices(crop: CropParams, out_hw: Tuple[int, int],
                        src_hw: Tuple[int, int]):
    """Nearest source (row, col) of each output cell: (N, out_h), (N, out_w)
    int64 (``functional.py:129-146``)."""
    out_h, out_w = out_hw
    src_h, src_w = src_hw
    dev = crop.y0.device
    ar_h = torch.arange(out_h, device=dev, dtype=torch.float32)
    ar_w = torch.arange(out_w, device=dev)
    rows = torch.floor(crop.y0[:, None] + (ar_h + 0.5) * (crop.h / out_h)[:, None])
    cols_base = torch.where(crop.flip[:, None], out_w - 1 - ar_w, ar_w).float()
    cols = torch.floor(crop.x0[:, None] + (cols_base + 0.5) * (crop.w / out_w)[:, None])
    rows = rows.to(torch.int32).clamp(0, src_h - 1).long()
    cols = cols.to(torch.int32).clamp(0, src_w - 1).long()
    return rows, cols


def pixel_ids_from_crop(crop: CropParams, out_hw: Tuple[int, int],
                        src_hw: Tuple[int, int], stride: int = 1) -> torch.Tensor:
    """Warped pixel-id maps (N, out_h, out_w) int32, from the crop geometry
    (``functional.py:149-174``): ids number source pixels 1..H·W row-major;
    ``stride`` > 1 snaps source coordinates to the stride grid's sample
    points first (``rescale_ids`` + nearest-exact upsample)."""
    src_h, src_w = src_hw
    rows, cols = crop_source_indices(crop, out_hw, src_hw)
    if stride > 1:
        red_h = len(range(stride // 2, src_h, stride))
        red_w = len(range(stride // 2, src_w, stride))
        rows = stride // 2 + torch.floor(
            (rows.float() + 0.5) * (red_h / src_h)
        ).to(torch.int32).clamp(0, red_h - 1).long() * stride
        cols = stride // 2 + torch.floor(
            (cols.float() + 0.5) * (red_w / src_w)
        ).to(torch.int32).clamp(0, red_w - 1).long() * stride
    return (rows[:, :, None] * src_w + cols[:, None, :] + 1).to(torch.int32)


def warp_id_map(id_map: torch.Tensor, crop: CropParams,
                out_hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest-warp (N, H, W) id/region maps through the crops
    (``functional.py:177-182``)."""
    rows, cols = crop_source_indices(crop, out_hw, tuple(id_map.shape[1:3]))
    n = torch.arange(id_map.shape[0], device=id_map.device)[:, None, None]
    return id_map[n, rows[:, :, None], cols[:, None, :]]


# ---------------------------------------------------------------------------
# photometric ops
# ---------------------------------------------------------------------------

_LUMA = (0.299, 0.587, 0.114)
JITTER_ORDERS = tuple(itertools.permutations(range(4)))  # 24 op orders


def _luma(x: torch.Tensor) -> torch.Tensor:
    """``x @ [0.299, 0.587, 0.114]`` over the channel axis, as a weighted
    sum: no weight tensor to copy to the device on every call."""
    return x[..., 0] * _LUMA[0] + x[..., 1] * _LUMA[1] + x[..., 2] * _LUMA[2]


def _per_image(v: torch.Tensor) -> torch.Tensor:
    """(N,) → (N, 1, 1, 1) for broadcasting against NHWC."""
    return v.reshape(-1, 1, 1, 1)


def _blend(a, b, factor):
    return torch.clamp(a * factor + b * (1.0 - factor), 0.0, 1.0)


def _rgb_to_hsv(rgb: torch.Tensor):
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.amax(dim=-1)
    minc = rgb.amin(dim=-1)
    v = maxc
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-12), 0.0)
    safe = torch.clamp(delta, min=1e-12)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta == 0, 0.0, h)
    # floor modulo, as jnp's %: fmod would leave negative hues negative
    h = torch.remainder(h / 6.0, 1.0)
    return h, s, v


def _hsv_to_rgb(h, s, v):
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def pick(options):
        out = options[-1]
        for idx in range(4, -1, -1):
            out = torch.where(i == idx, options[idx], out)
        return out

    r = pick([v, q, p, p, t, v])
    g = pick([t, v, v, q, p, p])
    b = pick([p, p, t, v, v, q])
    return torch.stack([r, g, b], dim=-1)


class JitterParams(NamedTuple):
    """Per-image brightness, contrast, saturation and hue factors, and the
    gate; one op order for the whole batch (an index into
    ``JITTER_ORDERS``, a host integer)."""

    brightness: torch.Tensor  # (N,)
    contrast: torch.Tensor
    saturation: torch.Tensor
    hue: torch.Tensor
    apply: torch.Tensor  # (N,) bool
    order: int = 0


def sample_color_jitter(
    generator: torch.Generator,
    n: int,
    brightness: Tuple[float, float] = (0.6, 1.4),
    contrast: Tuple[float, float] = (0.6, 1.4),
    saturation: Tuple[float, float] = (0.6, 1.4),
    hue: Tuple[float, float] = (-0.1, 0.1),
    p: float = 0.8,
    order: int = 0,
) -> JitterParams:
    dev = generator.device
    return JitterParams(
        brightness=_uniform(generator, (n,), *brightness, dev),
        contrast=_uniform(generator, (n,), *contrast, dev),
        saturation=_uniform(generator, (n,), *saturation, dev),
        hue=_uniform(generator, (n,), *hue, dev),
        apply=torch.rand(n, generator=generator, device=dev) < p,
        order=order,
    )


def color_jitter(img: torch.Tensor, params: JitterParams) -> torch.Tensor:
    """Brightness/contrast/saturation/hue jitter (``functional.py:241-299``)
    in the batch's op order, applied where the gate is set."""

    def op_brightness(x):
        return torch.clamp(x * _per_image(params.brightness), 0.0, 1.0)

    def op_contrast(x):
        # summed in float64: a float32 sum over the image rounds by ~1e-6
        # in whatever order the device reduces, the card's and the CPU's
        # differing; the float64 sum rounds once, to float32
        mean = _luma(x).double().mean(dim=(1, 2)).float()
        return _blend(x, _per_image(mean), _per_image(params.contrast))

    def op_saturation(x):
        return _blend(x, _luma(x)[..., None], _per_image(params.saturation))

    def op_hue(x):
        h, s, v = _rgb_to_hsv(x)
        return _hsv_to_rgb(torch.remainder(h + params.hue.reshape(-1, 1, 1), 1.0), s, v)

    ops = (op_brightness, op_contrast, op_saturation, op_hue)
    out = img
    for i in JITTER_ORDERS[params.order]:
        out = ops[i](out)
    return torch.where(_per_image(params.apply), out, img)


def sample_gate(generator: torch.Generator, n: int, p: float) -> torch.Tensor:
    """(N,) bool, ``U[0, 1) < p`` (``jax.random.bernoulli``)."""
    return torch.rand(n, generator=generator, device=generator.device) < p


def to_grayscale(img: torch.Tensor, apply: torch.Tensor) -> torch.Tensor:
    """Luma grayscale where ``apply`` is set (``functional.py:302-305``)."""
    gray = _luma(img)[..., None].expand_as(img)
    return torch.where(_per_image(apply), gray, img)


class BlurParams(NamedTuple):
    sigma: torch.Tensor  # (N,)
    apply: torch.Tensor  # (N,) bool


def sample_gaussian_blur(generator: torch.Generator, n: int,
                         sigma_range: Tuple[float, float] = (0.1, 2.0),
                         p: float = 0.5) -> BlurParams:
    dev = generator.device
    sigma = _uniform(generator, (n,), *sigma_range, dev)
    return BlurParams(sigma=sigma, apply=sample_gate(generator, n, p))


def _blur_band(kernel: torch.Tensor, size: int) -> torch.Tensor:
    """(N, size, size) band matrices: row h weights source
    clip(h + t - half, 0, size - 1) by ``kernel[:, t]`` (edge replicate
    folded in, ``functional.py:308-318``)."""
    taps = kernel.shape[1]
    half = taps // 2
    rows = torch.arange(size, device=kernel.device)[:, None]
    cols = torch.clamp(rows + torch.arange(taps, device=kernel.device)[None, :] - half,
                       0, size - 1)
    # (size, taps, size) one-hot by comparison: ``one_hot`` may check its
    # indices on the host, a device sync
    onehot = (cols[:, :, None] == torch.arange(size, device=kernel.device)).to(kernel.dtype)
    return torch.einsum("nt,htj->nhj", kernel, onehot)


def gaussian_blur(img: torch.Tensor, params: BlurParams,
                  kernel_size: int = 13) -> torch.Tensor:
    """Per-image Gaussian blur as ``K_v @ img @ K_hᵀ`` band products
    (``functional.py:321-353``), applied where the gate is set."""
    half = kernel_size // 2
    xs = torch.arange(-half, half + 1, dtype=torch.float32, device=img.device)
    kernel = torch.exp(-0.5 * (xs[None, :] / params.sigma[:, None]) ** 2)
    kernel = kernel / kernel.sum(dim=1, keepdim=True)
    h, w = img.shape[1], img.shape[2]
    kv = _blur_band(kernel, h).to(img.dtype)
    kh = kv if w == h else _blur_band(kernel, w).to(img.dtype)
    blurred = torch.einsum("nhs,nswc->nhwc", kv, img)
    blurred = torch.einsum("nws,nhsc->nhwc", kh, blurred)
    return torch.where(_per_image(params.apply), blurred, img)


class EraseParams(NamedTuple):
    """Erased rectangles: top-left corner and size, (N,) int64."""

    y0: torch.Tensor
    x0: torch.Tensor
    eh: torch.Tensor
    ew: torch.Tensor


def sample_random_erase(generator: torch.Generator, n: int, hw: Tuple[int, int],
                        scale: Tuple[float, float] = (0.5, 0.8),
                        ratio: Tuple[float, float] = (0.8, 1.25)) -> EraseParams:
    """The law of ``functional.py:458-482``: area ∈ U(scale)·H·W, log-aspect
    uniform, sides rounded half to even and clipped to [1, size].

    JAX draws the corner with ``randint(0, max(size - side + 1, 1))``, whose
    upper bound differs per image; ``torch.randint`` takes one scalar bound,
    so the corner is ``floor(u · bound)`` of a uniform ``u`` (clamped below
    the bound against rounding up), the same uniform law on the integers.
    """
    dev = generator.device
    h, w = hw
    area = h * w * _uniform(generator, (n,), scale[0], scale[1], dev)
    aspect = torch.exp(_uniform(generator, (n,), math.log(ratio[0]),
                                math.log(ratio[1]), dev))
    eh = torch.clamp(torch.round(torch.sqrt(area * aspect)), 1, h).long()
    ew = torch.clamp(torch.round(torch.sqrt(area / aspect)), 1, w).long()
    high_y = torch.clamp(h - eh + 1, min=1)
    high_x = torch.clamp(w - ew + 1, min=1)
    u_y = torch.rand(n, generator=generator, device=dev)
    u_x = torch.rand(n, generator=generator, device=dev)
    y0 = torch.minimum(torch.floor(u_y * high_y).long(), high_y - 1)
    x0 = torch.minimum(torch.floor(u_x * high_x).long(), high_x - 1)
    return EraseParams(y0=y0, x0=x0, eh=eh, ew=ew)


def random_erase(img: torch.Tensor, params: EraseParams,
                 value: float = 0.0) -> torch.Tensor:
    """Set each image's rectangle to ``value`` (``functional.py:483-486``)."""
    h, w = img.shape[1], img.shape[2]
    ys = torch.arange(h, device=img.device)[None, :, None]
    xs = torch.arange(w, device=img.device)[None, None, :]
    y0, x0 = params.y0[:, None, None], params.x0[:, None, None]
    inside = ((ys >= y0) & (ys < y0 + params.eh[:, None, None])
              & (xs >= x0) & (xs < x0 + params.ew[:, None, None]))
    return torch.where(inside[..., None], value, img)


# ---------------------------------------------------------------------------
# finetune geometry: flips and grid distortion of image and mask together
# ---------------------------------------------------------------------------


def flip_pair(img: torch.Tensor, mask: torch.Tensor, apply: torch.Tensor, dim: int):
    """Flip image (N, H, W, C) and mask (N, H, W) along ``dim`` (1 rows, 2
    columns) where ``apply`` (N,) is set."""
    gate = apply.reshape(-1, 1, 1)
    return (torch.where(gate[..., None], torch.flip(img, dims=(dim,)), img),
            torch.where(gate, torch.flip(mask, dims=(dim,)), mask))


class GridParams(NamedTuple):
    """Per-image cell stretches of each axis, (N, num_steps + 1), and the gate."""

    sx: torch.Tensor
    sy: torch.Tensor
    apply: torch.Tensor  # (N,) bool


def sample_grid_distortion(generator: torch.Generator, n: int, num_steps: int = 5,
                           distort_limit: float = 0.3, p: float = 0.2) -> GridParams:
    """The law of ``functional.py:422-437``: each cell stretch is
    ``1 + U(-distort_limit, distort_limit)``, gated with probability ``p``."""
    dev = generator.device
    shape = (n, num_steps + 1)
    sx = 1.0 + _uniform(generator, shape, -distort_limit, distort_limit, dev)
    sy = 1.0 + _uniform(generator, shape, -distort_limit, distort_limit, dev)
    return GridParams(sx=sx, sy=sy, apply=sample_gate(generator, n, p))


def _reflect101(coords: torch.Tensor, size: int) -> torch.Tensor:
    """OpenCV BORDER_REFLECT_101 folding: ...2 1 | 0 1 2 | 1 0..."""
    if size == 1:
        return torch.zeros_like(coords)
    period = 2.0 * (size - 1)
    c = torch.remainder(coords.abs(), period)
    return torch.where(c > size - 1, period - c, c)


def _grid_axis_coords(steps: torch.Tensor, size: int, num_steps: int) -> torch.Tensor:
    """(N, size) distorted source coordinates along one axis
    (``functional.py:365-388``): the axis is cut into ``num_steps`` cells of
    ``size // num_steps`` pixels, cell i stretched by ``steps[:, i]``; the
    remainder cell ends exactly at ``size``."""
    dev = steps.device
    step = size // num_steps
    start = torch.arange(num_steps + 1, device=dev) * step
    full = start + step <= size
    widths = torch.where(full, step * steps, 0.0)
    # a running sum in a fixed order: the card's parallel cumsum rounds
    # otherwise than the CPU's, and a coordinate 1 ulp off moves the
    # bilinear weights by ~3e-5 at 352 pixels
    sums = [torch.zeros_like(widths[:, 0])]
    for i in range(num_steps):
        sums.append(sums[-1] + widths[:, i])
    prev = torch.stack(sums, 1)
    cur = torch.where(full, prev + step * steps, float(size))
    n = torch.clamp(torch.clamp(start + step, max=size) - start, min=1)
    x = torch.arange(size, device=dev)
    idx = torch.clamp(x // step, max=num_steps)
    t = (x - start[idx]) / torch.clamp(n[idx] - 1, min=1)
    return prev[:, idx] + (cur[:, idx] - prev[:, idx]) * t


def _axis_resample_matrix(coords: torch.Tensor, size: int) -> torch.Tensor:
    """(N, out, src) bilinear weights of 1-D coordinates folded by
    BORDER_REFLECT_101 (``functional.py:391-400``)."""
    c = _reflect101(coords, size)
    f = torch.floor(c)
    t = (c - f)[..., None]
    i0 = f.to(torch.int32).clamp(0, size - 1)[..., None]
    i1 = (i0 + 1).clamp(0, size - 1)
    cols = torch.arange(size, device=coords.device)
    return (cols == i0) * (1.0 - t) + (cols == i1) * t


def grid_distortion(img: torch.Tensor, mask: Optional[torch.Tensor], params: GridParams,
                    num_steps: int = 5):
    """Albumentations GridDistortion (``functional.py:403-455``): the image
    (N, H, W, C) float32 resampled bilinearly as two batched products, the
    mask (N, H, W) by nearest through the same coordinates, each where the
    gate is set.

    The JAX op warps the mask as two one-hot products and rounds; a gather
    at ``round(reflect101(coordinate))`` picks the same ids.
    """
    h, w = img.shape[1], img.shape[2]
    xx = _grid_axis_coords(params.sx, w, num_steps)
    yy = _grid_axis_coords(params.sy, h, num_steps)
    wx = _axis_resample_matrix(xx, w).to(img.dtype)
    wy = _axis_resample_matrix(yy, h).to(img.dtype)
    tmp = torch.einsum("nxk,nykc->nyxc", wx, img)
    warped = torch.einsum("nyj,njxc->nyxc", wy, tmp)
    out_img = torch.where(_per_image(params.apply), warped, img)
    if mask is None:
        return out_img
    iy = torch.round(_reflect101(yy, h)).to(torch.int32).clamp(0, h - 1).long()
    ix = torch.round(_reflect101(xx, w)).to(torch.int32).clamp(0, w - 1).long()
    rows = torch.arange(mask.shape[0], device=mask.device)[:, None, None]
    warped_mask = mask[rows, iy[:, :, None], ix[:, None, :]]
    return out_img, torch.where(params.apply.reshape(-1, 1, 1), warped_mask, mask)
