"""The augmentations, written plainly, and the draws they are made with.

Randomness.  A training step draws its augmentation (and the finetune
head's dropout) from a ``torch.Generator`` on the device, seeded from
(run seed, step, stream) by the law below, and each law takes its uniforms
in a fixed order.  The reference replays that law and that order, so it
draws the same numbers; everything computed from them (crop boxes and
their resampling weights, photometric factors, erased rectangles, the grid
distortion's coordinates) it works out again here.

Geometry and arithmetic follow the published operations: RandomResizedCrop
(torchvision's law: 10 attempts, then a centre crop) resampled with a
linear kernel at half-pixel centres and no antialiasing; colour jitter in
the order brightness, contrast, saturation, hue with ITU-R 601 luma; 13-tap
Gaussian blur with edge replication; random erasing to zero; flips; the
albumentations grid distortion (5 cells per axis, BORDER_REFLECT_101); and
additive Gaussian noise on the 0..255 scale.  Images are NHWC float32 in
[0, 1].
"""

from __future__ import annotations

import math
from typing import Dict

import torch

SEED_MIX = 0x9E3779B97F4A7C15
STREAM_MIX = 0xD1B54A32D192ED03
LUMA = (0.299, 0.587, 0.114)


def step_generator(seed: int, step: int, device, stream: int = 0) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * SEED_MIX + int(step) + int(stream) * STREAM_MIX) % (1 << 63))
    return g


def uniform(g, shape, lo, hi):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=g.device)


def gate(g, n, p):
    return torch.rand(n, generator=g, device=g.device) < p


# ---------------------------------------------------------------------------
# draws
# ---------------------------------------------------------------------------

def draw_crop(g, n, src_hw, scale=(0.2, 1.0), ratio=(3 / 4, 4 / 3), flip_p=0.5, attempts=10):
    height, width = src_hw
    area = float(height * width)
    target = area * uniform(g, (n, attempts), scale[0], scale[1])
    aspect = torch.exp(uniform(g, (n, attempts), math.log(ratio[0]), math.log(ratio[1])))
    ws, hs = torch.sqrt(target * aspect), torch.sqrt(target / aspect)
    ok = (ws <= width) & (hs <= height)
    first = torch.argmax(ok.to(torch.int32), dim=1, keepdim=True)
    found = ok.any(dim=1)
    in_ratio = width / height
    if in_ratio < ratio[0]:
        fb_w, fb_h = float(width), width / ratio[0]
    elif in_ratio > ratio[1]:
        fb_w, fb_h = height * ratio[1], float(height)
    else:
        fb_w, fb_h = float(width), float(height)
    w = torch.where(found, ws.gather(1, first)[:, 0], torch.full((n,), fb_w, device=g.device))
    h = torch.where(found, hs.gather(1, first)[:, 0], torch.full((n,), fb_h, device=g.device))
    uy = torch.rand(n, generator=g, device=g.device)
    ux = torch.rand(n, generator=g, device=g.device)
    y0 = torch.where(found, uy * (height - h), (height - h) / 2.0)
    x0 = torch.where(found, ux * (width - w), (width - w) / 2.0)
    flip = torch.rand(n, generator=g, device=g.device) < flip_p
    return dict(y0=y0, x0=x0, h=h, w=w, flip=flip)


def draw_jitter(g, n, brightness, contrast, saturation, hue, p):
    return dict(brightness=uniform(g, (n,), *brightness), contrast=uniform(g, (n,), *contrast),
                saturation=uniform(g, (n,), *saturation), hue=uniform(g, (n,), *hue),
                apply=gate(g, n, p))


def draw_view(g, n, src_hw, cfg):
    crop = draw_crop(g, n, src_hw, tuple(cfg["crop_scale"]), tuple(cfg["crop_ratio"]),
                     cfg["flip_p"])
    jitter = draw_jitter(g, n, cfg["brightness"], cfg["contrast"], cfg["saturation"],
                         cfg["hue"], cfg["jitter_p"])
    gray = gate(g, n, cfg["grayscale_p"])
    sigma = uniform(g, (n,), *cfg["blur_sigma"])
    blur = gate(g, n, cfg["blur_p"])
    return dict(crop=crop, jitter=jitter, gray=gray, sigma=sigma, blur=blur)


def draw_erase(g, n, hw, scale, ratio):
    h, w = hw
    area = h * w * uniform(g, (n,), *scale)
    aspect = torch.exp(uniform(g, (n,), math.log(ratio[0]), math.log(ratio[1])))
    eh = torch.clamp(torch.round(torch.sqrt(area * aspect)), 1, h).long()
    ew = torch.clamp(torch.round(torch.sqrt(area / aspect)), 1, w).long()
    high_y, high_x = torch.clamp(h - eh + 1, min=1), torch.clamp(w - ew + 1, min=1)
    uy = torch.rand(n, generator=g, device=g.device)
    ux = torch.rand(n, generator=g, device=g.device)
    y0 = torch.minimum(torch.floor(uy * high_y).long(), high_y - 1)
    x0 = torch.minimum(torch.floor(ux * high_x).long(), high_x - 1)
    return dict(y0=y0, x0=x0, eh=eh, ew=ew)


# ---------------------------------------------------------------------------
# operations
# ---------------------------------------------------------------------------

def _per_image(v):
    return v.reshape(-1, 1, 1, 1)


def _luma(x):
    return x[..., 0] * LUMA[0] + x[..., 1] * LUMA[1] + x[..., 2] * LUMA[2]


def _linear_taps(pos: torch.Tensor, size: int):
    """Two-tap linear weights at sample positions ``pos`` (N, out) over a
    source axis of ``size``: the taps outside the axis are dropped and the
    rest renormalised; a position beyond half a pixel of either edge reads
    nothing."""
    j0 = torch.floor(pos)
    f = pos - j0
    j0 = j0.long()
    j1 = j0 + 1
    w0 = torch.where((j0 >= 0) & (j0 < size), 1.0 - f, torch.zeros_like(f))
    w1 = torch.where((j1 >= 0) & (j1 < size), f, torch.zeros_like(f))
    total = w0 + w1
    norm = torch.where(total > 1000.0 * torch.finfo(torch.float32).eps, total,
                       torch.full_like(total, float("inf")))
    inside = (pos >= -0.5) & (pos <= size - 0.5)
    w0 = torch.where(inside, w0 / norm, torch.zeros_like(w0))
    w1 = torch.where(inside, w1 / norm, torch.zeros_like(w1))
    return j0.clamp(0, size - 1), w0, j1.clamp(0, size - 1), w1


def _gather_axis(img, idx, dim):
    """img (N, H, W, C), idx (N, out) → rows (dim 1) or columns (dim 2)."""
    n, h, w, c = img.shape
    if dim == 1:
        return img.gather(1, idx[:, :, None, None].expand(n, idx.shape[1], w, c))
    return img.gather(2, idx[:, None, :, None].expand(n, h, idx.shape[1], c))


def _resample(img, pos, dim):
    i0, w0, i1, w1 = _linear_taps(pos, img.shape[dim])
    shape = (-1, pos.shape[1], 1, 1) if dim == 1 else (-1, 1, pos.shape[1], 1)
    return (_gather_axis(img, i0, dim) * w0.view(shape)
            + _gather_axis(img, i1, dim) * w1.view(shape))


def crop_resize(img, crop, out_hw):
    """Crop and resize in one linear resampling, the flip folded in."""
    out_h, out_w = out_hw
    dev = img.device
    oy = torch.arange(out_h, device=dev, dtype=torch.float32)[None] + 0.5
    ox = torch.arange(out_w, device=dev, dtype=torch.float32)[None] + 0.5
    sy = out_h / crop["h"]
    sx = out_w / crop["w"]
    scale_x = torch.where(crop["flip"], -sx, sx)
    ty = -crop["y0"] * out_h / crop["h"]
    tx = torch.where(crop["flip"], (crop["x0"] + crop["w"]) * sx, -crop["x0"] * sx)
    pos_y = oy * (1.0 / sy)[:, None] - (ty * (1.0 / sy))[:, None] - 0.5
    pos_x = ox * (1.0 / scale_x)[:, None] - (tx * (1.0 / scale_x))[:, None] - 0.5
    return _resample(_resample(img, pos_y, 1), pos_x, 2)


def _blend(a, b, f):
    return torch.clamp(a * f + b * (1.0 - f), 0.0, 1.0)


def _hue_shift(x, shift):
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    mx, mn = x.amax(dim=-1), x.amin(dim=-1)
    delta = mx - mn
    s = torch.where(mx > 0, delta / mx.clamp_min(1e-12), torch.zeros_like(mx))
    d = delta.clamp_min(1e-12)
    h = torch.where(mx == r, (g - b) / d, torch.where(mx == g, 2.0 + (b - r) / d,
                                                         4.0 + (r - g) / d))
    h = torch.where(delta == 0, torch.zeros_like(h), h)
    h = torch.remainder(torch.remainder(h / 6.0, 1.0) + shift.view(-1, 1, 1), 1.0)
    v = mx
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p, q, t = v * (1.0 - s), v * (1.0 - s * f), v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.long(), 6)
    table = torch.stack([torch.stack(c, dim=-1) for c in
                         ((v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q))])
    return table.gather(0, i[None, ..., None].expand(1, *i.shape, 3))[0]


def color_jitter(x, j):
    out = torch.clamp(x * _per_image(j["brightness"]), 0.0, 1.0)
    mean = _luma(out).double().mean(dim=(1, 2)).float()
    out = _blend(out, _per_image(mean), _per_image(j["contrast"]))
    out = _blend(out, _luma(out)[..., None], _per_image(j["saturation"]))
    out = _hue_shift(out, j["hue"])
    return torch.where(_per_image(j["apply"]), out, x)


def gaussian_blur(x, sigma, apply, taps=13):
    half = taps // 2
    t = torch.arange(-half, half + 1, device=x.device, dtype=torch.float32)
    k = torch.exp(-0.5 * (t[None] / sigma[:, None]) ** 2)
    k = k / k.sum(dim=1, keepdim=True)
    out = x
    for dim in (1, 2):
        size = out.shape[dim]
        acc = torch.zeros_like(out)
        base = torch.arange(size, device=x.device)
        for i in range(taps):
            idx = (base + i - half).clamp(0, size - 1)
            shifted = out.index_select(dim, idx)
            acc = acc + shifted * k[:, i].view(-1, 1, 1, 1)
        out = acc
    return torch.where(_per_image(apply), out, x)


def erase(x, e):
    h, w = x.shape[1], x.shape[2]
    ys = torch.arange(h, device=x.device)[None, :, None]
    xs = torch.arange(w, device=x.device)[None, None, :]
    y0, x0 = e["y0"][:, None, None], e["x0"][:, None, None]
    inside = ((ys >= y0) & (ys < y0 + e["eh"][:, None, None])
              & (xs >= x0) & (xs < x0 + e["ew"][:, None, None]))
    return torch.where(inside[..., None], torch.zeros((), device=x.device), x)


def view(img, v, out_hw):
    y = crop_resize(img, v["crop"], out_hw)
    y = color_jitter(y, v["jitter"])
    y = torch.where(_per_image(v["gray"]), _luma(y)[..., None].expand_as(y), y)
    return gaussian_blur(y, v["sigma"], v["blur"])


def pretrain_augment(g, raw: Dict[str, torch.Tensor], cfg: dict) -> Dict[str, torch.Tensor]:
    """CP2's batch from uint8 frames ``fg``, ``bg0``, ``bg1``: two views of
    the foreground, two erased backgrounds."""
    n, src_hw = raw["fg"].shape[0], tuple(raw["fg"].shape[1:3])
    out_hw = tuple(cfg["out_hw"])
    views = [draw_view(g, n, src_hw, cfg) for _ in range(4)]
    erases = [draw_erase(g, n, out_hw, cfg["erase_scale"], cfg["erase_ratio"])
              for _ in range(2)]
    fg = raw["fg"].float() / 255.0
    return {"img_a": view(fg, views[0], out_hw), "img_b": view(fg, views[1], out_hw),
            "bg0": erase(view(raw["bg0"].float() / 255.0, views[2], out_hw), erases[0]),
            "bg1": erase(view(raw["bg1"].float() / 255.0, views[3], out_hw), erases[1])}


# ---------------------------------------------------------------------------
# finetune
# ---------------------------------------------------------------------------

def _reflect101(c, size):
    period = 2.0 * (size - 1)
    c = torch.remainder(c.abs(), period)
    return torch.where(c > size - 1, period - c, c)


def _grid_coords(steps, size, cells=5):
    """Source coordinate of each pixel of one axis: the axis cut into
    ``cells`` cells of ``size // cells`` pixels, cell i stretched by
    ``steps[:, i]``, and a last partial cell that ends at ``size``."""
    dev = steps.device
    step = size // cells
    start = torch.arange(cells + 1, device=dev) * step
    full = start + step <= size
    widths = torch.where(full, step * steps, torch.zeros_like(steps))
    prev = [torch.zeros_like(widths[:, 0])]
    for i in range(cells):
        prev.append(prev[-1] + widths[:, i])
    prev = torch.stack(prev, 1)
    cur = torch.where(full, prev + step * steps, torch.full_like(prev, float(size)))
    length = torch.clamp(torch.clamp(start + step, max=size) - start, min=1)
    x = torch.arange(size, device=dev)
    cell = torch.clamp(x // step, max=cells)
    t = (x - start[cell]) / torch.clamp(length[cell] - 1, min=1)
    return prev[:, cell] + (cur[:, cell] - prev[:, cell]) * t


def _distort(img, mask, sx, sy, apply):
    h, w = img.shape[1], img.shape[2]
    cx = _reflect101(_grid_coords(sx, w), w)
    cy = _reflect101(_grid_coords(sy, h), h)

    def taps(c, size):
        f = torch.floor(c)
        t = c - f
        i0 = f.long().clamp(0, size - 1)
        return i0, 1.0 - t, (i0 + 1).clamp(0, size - 1), t

    def along(x, c, dim):
        i0, w0, i1, w1 = taps(c, x.shape[dim])
        shape = (-1, c.shape[1], 1, 1) if dim == 1 else (-1, 1, c.shape[1], 1)
        return _gather_axis(x, i0, dim) * w0.view(shape) + _gather_axis(x, i1, dim) * w1.view(shape)

    warped = along(along(img, cx, 2), cy, 1)
    iy = torch.round(cy).long().clamp(0, h - 1)
    ix = torch.round(cx).long().clamp(0, w - 1)
    rows = torch.arange(mask.shape[0], device=mask.device)[:, None, None]
    wmask = mask[rows, iy[:, :, None], ix[:, None, :]]
    return (torch.where(_per_image(apply), warped, img),
            torch.where(apply.view(-1, 1, 1), wmask, mask))


def finetune_augment(g, images: torch.Tensor, masks: torch.Tensor, cfg: dict):
    """The polyp train transform on the card's side: flips, colour jitter,
    grid distortion, Gaussian noise; uint8 images → float32 in [0, 1]."""
    n, h, w, c = images.shape
    hflip, vflip = gate(g, n, cfg["hflip_p"]), gate(g, n, cfg["vflip_p"])
    jitter = draw_jitter(g, n, cfg["brightness"], cfg["contrast"], cfg["saturation"],
                         cfg["hue"], cfg["jitter_p"])
    lim = cfg["distort_limit"]
    sx = 1.0 + uniform(g, (n, 6), -lim, lim)
    sy = 1.0 + uniform(g, (n, 6), -lim, lim)
    distort = gate(g, n, cfg["distort_p"])
    var = uniform(g, (n,), *cfg["noise_var"])
    normal = torch.randn((n, h, w, c), generator=g, device=g.device)
    noisy = gate(g, n, cfg["noise_p"])

    img = images.float() / 255.0
    for flag, dim in ((hflip, 2), (vflip, 1)):
        img = torch.where(_per_image(flag), img.flip(dim), img)
        masks = torch.where(flag.view(-1, 1, 1), masks.flip(dim), masks)
    img = color_jitter(img, jitter)
    img, masks = _distort(img, masks, sx, sy, distort)
    moved = torch.clamp(img + normal * _per_image(torch.sqrt(var)) / 255.0, 0.0, 1.0)
    return torch.where(_per_image(noisy), moved, img), masks
