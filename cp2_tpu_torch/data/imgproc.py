"""The image operations of the mmseg pipelines, computed as OpenCV computes
them, in numpy and PIL, without OpenCV.

The JAX package's pipelines (``cp2_tpu/data/pipelines.py``) call cv2 for
reading, resizing, rotation, HSV and CLAHE; the card machine has no cv2.
Each function here reproduces the arithmetic of the cv2 call it replaces,
held to cv2 5.0 on x86-64 by ``tests/test_torch_mmseg_data.py``:

* ``imread`` decodes with PIL.  ``IMREAD_COLOR`` is the RGB image (alpha
  stripped, palette expanded, grey replicated); ``IMREAD_GRAYSCALE`` of a
  colour or palette PNG is libpng's luma, which cv2's PNG decoder asks for:
  15-bit weights 9797/19234/3737, truncated.  Equal to cv2 for PNGs of
  modes 1, L, LA, P, RGB and RGBA.  JPEG decoders differ between libraries:
  no parity is claimed for JPEG.
* ``resize_nearest`` is ``INTER_NEAREST``: source index
  ``floor(dst * (1 / (dst_size / src_size)))`` in float64, clamped.
  Bit-exact for any dtype.
* ``resize_linear`` is ``INTER_LINEAR``.  On uint8 it is cv2's fixed
  point: 11-bit weights, rows clamped but their weights not, and the
  vertical pass of cv2's vector code (``(((S0>>4)*b0>>16) + ((S1>>4)*b1>>16)
  + 2) >> 2``); an exact 2x reduction on both axes is cv2's fast area mean.
  Bit-exact.  On float input it is the same sampling in float32.
* ``warp_affine`` is ``warpAffine`` with the inverse map computed as cv2
  inverts it.  ``INTER_NEAREST`` is cv2's fixed point (10-bit coordinates,
  rounded by half a unit): bit-exact.  ``INTER_LINEAR`` follows cv2 5's
  float32 path (source coordinate ``M0*x + (M1*y + M2)`` in float32,
  lerps in x then y, rounded half to even).  cv2's vector code orders some
  of those float32 operations otherwise, which this function does not
  reproduce: on uint8 it differs by one level on at most 0.05 % of the
  pixels (69 rotations of the tests' images), on float32 by at most 2e-3.
  Out-of-image taps read ``border_value`` (a scalar pads the first channel
  only, as cv2's ``Scalar(v, 0, 0, 0)`` does).
* ``rgb_to_hsv`` / ``hsv_to_rgb`` are ``COLOR_RGB2HSV`` / ``COLOR_HSV2RGB``
  on uint8 with H in [0, 180).  The forward is cv2's integer code
  (``hsv_shift`` 12 division tables): bit-exact.  The inverse is float32
  with fused multiply-adds; cv2 computes the blocks of 32 pixels of each
  row with its vector code (truncated sector, truncation to uint8) and the
  rest of the row with its scalar code (floored sector, rounding), and so
  does this function.  Bit-exact on all 2^24 inputs, either path, with
  cv2's AVX2 build; a build with another vector width splits rows
  elsewhere and differs by at most one level on the pixels it splits
  differently.
* ``clahe`` is ``createCLAHE(clip, grid).apply`` on one uint8 channel:
  clip limit ``max(int(clip * tile_area / 256), 1)``, the excess spread
  with a residual step, LUTs scaled by ``255 / tile_area``, bilinear
  blending of the four tiles' LUTs in float32, and ``BORDER_REFLECT_101``
  padding for the histograms when the grid does not divide the image.
  Bit-exact.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

IMREAD_COLOR = 1
IMREAD_GRAYSCALE = 0

_F32 = np.float32

# libpng's png_set_rgb_to_gray(0.299, 0.587): red and green scaled to 1/32768
# and truncated, blue the rest of 32768
_LUMA_R, _LUMA_G = 29900 * 32768 // 100000, 58700 * 32768 // 100000
_LUMA_B = 32768 - _LUMA_R - _LUMA_G


def imread(path: str, flag: int = IMREAD_COLOR) -> np.ndarray:
    """``cv2.imread`` followed by BGR→RGB for colour: (H, W, 3) or (H, W)
    uint8.  Raises ``FileNotFoundError`` where cv2 returns None."""
    from PIL import Image

    try:
        with open(path, "rb") as f:
            img = Image.open(f)
            img.load()
    except (FileNotFoundError, IsADirectoryError) as e:
        raise FileNotFoundError(path) from e
    if img.mode not in ("1", "L", "LA", "P", "RGB", "RGBA"):
        raise ValueError(f"{path}: PNG mode {img.mode!r} is not supported")
    if flag == IMREAD_COLOR:
        return np.asarray(img.convert("RGB"), np.uint8)
    if img.mode in ("1", "L", "LA"):
        return np.asarray(img.convert("L"), np.uint8)
    rgb = np.asarray(img.convert("RGB"), np.int64)
    return ((rgb[..., 0] * _LUMA_R + rgb[..., 1] * _LUMA_G + rgb[..., 2] * _LUMA_B)
            >> 15).astype(np.uint8)


def _nn_index(dst: int, src: int) -> np.ndarray:
    scale = 1.0 / (dst / src)
    return np.minimum(np.floor(np.arange(dst) * scale).astype(np.int64), src - 1)


def resize_nearest(img: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=INTER_NEAREST)``."""
    w, h = size_wh
    rows = _nn_index(h, img.shape[0])
    cols = _nn_index(w, img.shape[1])
    return img[rows[:, None], cols[None, :]]


def _linear_taps(src: int, dst: int, clamp: bool):
    """Source taps and float32 weights of one axis (cv2 ``resizeGeneric``):
    ``fx = (d + 0.5) * scale - 0.5`` in float32; the x axis clamps its
    out-of-range taps to weight (1, 0), the y axis keeps its weights and
    clamps the rows."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(_F32)
    s = np.floor(f).astype(np.int64)
    f = (f - s).astype(_F32)
    if clamp:
        out = (s < 0) | (s >= src - 1)
        f[out] = 0
        s = np.where(s < 0, 0, np.where(s >= src - 1, src - 1, s))
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), (_F32(1) - f), f


def resize_linear(img: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=INTER_LINEAR)`` of an
    (H, W) or (H, W, C) uint8 or float image."""
    w, h = size_wh
    sh, sw = img.shape[:2]
    if (w, h) == (sw, sh):
        return img.copy()
    chan = (None,) if img.ndim == 3 else ()
    if sw == 2 * w and sh == 2 * h:
        # cv2 takes an exact halving on both axes as its fast area mean
        x = img.astype(np.int64 if img.dtype == np.uint8 else _F32)
        s = x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]
        if img.dtype == np.uint8:
            return ((s + 2) >> 2).astype(np.uint8)
        return (s * _F32(0.25)).astype(_F32)
    x0, x1, a0, a1 = _linear_taps(sw, w, clamp=True)
    y0, y1, b0, b1 = _linear_taps(sh, h, clamp=False)
    ex = (None, slice(None)) + chan
    ey = (slice(None), None) + chan
    if img.dtype == np.uint8:
        ia0, ia1 = (np.rint(a * _F32(2048)).astype(np.int64) for a in (a0, a1))
        ib0, ib1 = (np.rint(b * _F32(2048)).astype(np.int64) for b in (b0, b1))
        src = img.astype(np.int64)
        rows = src[:, x0] * ia0[ex] + src[:, x1] * ia1[ex]
        out = ((((rows[y0] >> 4) * ib0[ey]) >> 16)
               + (((rows[y1] >> 4) * ib1[ey]) >> 16) + 2) >> 2
        return np.clip(out, 0, 255).astype(np.uint8)
    src = img.astype(_F32)
    rows = src[:, x0] * a0[ex] + src[:, x1] * a1[ex]
    return (rows[y0] * b0[ey] + rows[y1] * b1[ey]).astype(_F32)


def rotation_matrix(center: Tuple[float, float], angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: (2, 3) float64."""
    a = np.deg2rad(angle)
    alpha, beta = np.cos(a) * scale, np.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _invert_affine(m: np.ndarray) -> np.ndarray:
    """cv2 ``invertAffineTransform`` as ``warpAffine`` does it, flat (6,)."""
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22, a12, a21 = m[1, 1] * d, m[0, 0] * d, -m[0, 1] * d, -m[1, 0] * d
    b1 = -a11 * m[0, 2] - a12 * m[1, 2]
    b2 = -a21 * m[0, 2] - a22 * m[1, 2]
    return np.array([a11, a12, b1, a21, a22, b2])


def _taps(img, ys, xs, border_value):
    """``img[ys, xs]`` where inside, ``border_value`` outside."""
    h, w = img.shape[:2]
    inside = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    vals = img[np.clip(ys, 0, h - 1), np.clip(xs, 0, w - 1)]
    if img.ndim == 3:
        inside = inside[..., None]
    return np.where(inside, vals, np.asarray(border_value, vals.dtype))


def warp_affine(img: np.ndarray, m: np.ndarray, size_wh: Tuple[int, int], *,
                nearest: bool, border_value=0) -> np.ndarray:
    """``cv2.warpAffine(img, m, (w, h), flags=INTER_NEAREST or
    INTER_LINEAR, borderMode=BORDER_CONSTANT, borderValue=border_value)``.

    As in cv2, a scalar ``border_value`` is the first channel's; the other
    channels of a multi-channel image are padded with 0."""
    w, h = size_wh
    if img.ndim == 3 and np.isscalar(border_value):
        border_value = [border_value] + [0] * (img.shape[2] - 1)
    mi = _invert_affine(np.asarray(m, np.float64))
    if nearest:
        ab = 1024  # AB_BITS 10, rounded by half a unit
        xs, ys = np.arange(w), np.arange(h)
        adelta = np.rint(mi[0] * xs * ab).astype(np.int64)
        bdelta = np.rint(mi[3] * xs * ab).astype(np.int64)
        x0 = np.rint((mi[1] * ys + mi[2]) * ab).astype(np.int64) + ab // 2
        y0 = np.rint((mi[4] * ys + mi[5]) * ab).astype(np.int64) + ab // 2
        sx = (x0[:, None] + adelta[None, :]) >> 10
        sy = (y0[:, None] + bdelta[None, :]) >> 10
        return _taps(img, sy, sx, border_value)
    mf = mi.astype(_F32)
    xs = np.arange(w, dtype=_F32)[None, :]
    ys = np.arange(h, dtype=_F32)[:, None]
    fx = (mf[0] * xs + (mf[1] * ys + mf[2])).astype(_F32)
    fy = (mf[3] * xs + (mf[4] * ys + mf[5])).astype(_F32)
    sx = np.floor(fx).astype(np.int64)
    sy = np.floor(fy).astype(np.int64)
    ax = (fx - sx).astype(_F32)
    ay = (fy - sy).astype(_F32)
    if img.ndim == 3:
        ax, ay = ax[..., None], ay[..., None]
    src = img.astype(_F32)
    p00, p01 = _taps(src, sy, sx, border_value), _taps(src, sy, sx + 1, border_value)
    p10, p11 = _taps(src, sy + 1, sx, border_value), _taps(src, sy + 1, sx + 1, border_value)
    top = p00 + ax * (p01 - p00)
    bottom = p10 + ax * (p11 - p10)
    out = (top + ay * (bottom - top)).astype(_F32)
    if img.dtype == np.uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out


_HSV_SHIFT = 12
_SDIV = np.zeros(256, np.int64)
_HDIV = np.zeros(256, np.int64)
_SDIV[1:] = np.rint((255 << _HSV_SHIFT) / np.arange(1, 256, dtype=np.float64))
_HDIV[1:] = np.rint((180 << _HSV_SHIFT) / (6.0 * np.arange(1, 256, dtype=np.float64)))
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])
_HSV_VECTOR_BLOCK = 32  # pixels cv2's AVX2 HSV2RGB_b takes per vector iteration


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, COLOR_RGB2HSV)`` on (H, W, 3) uint8."""
    x = img.astype(np.int64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    s = (diff * _SDIV[v] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


def _one_minus_product(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``1 - a*b`` rounded once to float32, as a fused multiply-add gives it."""
    return (1.0 - a.astype(np.float64) * b.astype(np.float64)).astype(_F32)


def hsv_to_rgb(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, COLOR_HSV2RGB)`` on (H, W, 3) uint8."""
    one = _F32(1)
    h = img[..., 0].astype(_F32) * _F32(6.0 / 180)
    s = img[..., 1].astype(_F32) * _F32(1.0 / 255)
    v = img[..., 2].astype(_F32) * _F32(1.0 / 255)
    # vector code: truncated sector, fused products, truncation to uint8
    pre = np.trunc(h).astype(_F32)
    frac = (h - pre).astype(_F32)
    sector = (pre - np.trunc(pre * _F32(1.0 / 6)) * _F32(6)).astype(np.int64)
    tab = np.stack([v, v * (one - s), v * _one_minus_product(s, frac),
                    v * _one_minus_product(s, (one - frac).astype(_F32))], -1)
    bgr = np.take_along_axis(tab, _SECTORS[np.clip(sector, 0, 5)], -1)
    vec = np.clip(np.trunc(bgr[..., ::-1] * _F32(255)), 0, 255)
    # scalar code: fmod/floor sector, the same fused products, rounding
    hs = np.fmod(h, _F32(6))
    hs = np.where(hs < 0, hs + _F32(6), hs).astype(_F32)
    sector = np.floor(hs).astype(np.int64)
    frac = (hs - sector).astype(_F32)
    bad = (sector < 0) | (sector >= 6)
    sector = np.where(bad, 0, sector)
    frac = np.where(bad, _F32(0), frac)
    tab = np.stack([v, v * (one - s), v * _one_minus_product(s, frac),
                    v * _one_minus_product(s, (one - frac).astype(_F32))], -1)
    bgr = np.take_along_axis(tab, _SECTORS[sector], -1)
    bgr = np.where((s == 0)[..., None], v[..., None], bgr)
    sca = np.clip(np.rint(bgr[..., ::-1] * _F32(255)), 0, 255)
    width = img.shape[1]
    in_vector = np.arange(width) < width // _HSV_VECTOR_BLOCK * _HSV_VECTOR_BLOCK
    return np.where(in_vector[None, :, None], vec, sca).astype(np.uint8)


def clahe(channel: np.ndarray, clip_limit: float, tile_grid_size: Sequence[int]) -> np.ndarray:
    """``cv2.createCLAHE(clip_limit, tile_grid_size).apply`` on (H, W) uint8."""
    gx, gy = tile_grid_size
    img = np.asarray(channel, np.uint8)
    h, w = img.shape
    ext = img
    if h % gy or w % gx:
        ext = np.pad(img, ((0, (gy - h % gy) % gy), (0, (gx - w % gx) % gx)),
                     mode="reflect")  # BORDER_REFLECT_101
    th, tw = ext.shape[0] // gy, ext.shape[1] // gx
    area = th * tw
    limit = max(int(clip_limit * area / 256), 1) if clip_limit > 0 else 0
    tiles = ext[:gy * th, :gx * tw].reshape(gy, th, gx, tw).transpose(0, 2, 1, 3)
    offsets = (np.arange(gy * gx) * 256).reshape(gy, gx, 1, 1)
    hist = np.bincount((tiles.astype(np.int64) + offsets).ravel(),
                       minlength=gy * gx * 256).reshape(gy, gx, 256)
    if limit > 0:
        clipped = np.maximum(hist - limit, 0).sum(-1, keepdims=True)
        hist = np.minimum(hist, limit) + clipped // 256
        residual = (clipped % 256)[..., 0]
        step = np.maximum(256 // np.maximum(residual, 1), 1)
        bins = np.arange(256)
        hist += ((bins % step[..., None] == 0)
                 & (bins // step[..., None] < residual[..., None]))
    lut = np.clip(np.rint(np.cumsum(hist, -1).astype(_F32) * _F32(255.0 / area)), 0, 255)
    lut = lut.astype(_F32)

    def grid_weights(n, tile, tiles_n):
        f = (np.arange(n, dtype=_F32) * (_F32(1) / _F32(tile)) - _F32(0.5)).astype(_F32)
        i1 = np.floor(f).astype(np.int64)
        a = (f - i1).astype(_F32)
        return np.maximum(i1, 0), np.minimum(i1 + 1, tiles_n - 1), _F32(1) - a, a

    y1, y2, ya1, ya = grid_weights(h, th, gy)
    x1, x2, xa1, xa = grid_weights(w, tw, gx)
    v = img.astype(np.int64)

    def at(ty, tx):
        return lut[ty[:, None], tx[None, :], v]

    res = ((at(y1, x1) * xa1[None] + at(y1, x2) * xa[None]) * ya1[:, None]
           + (at(y2, x1) * xa1[None] + at(y2, x2) * xa[None]) * ya[:, None])
    return np.clip(np.rint(res), 0, 255).astype(np.uint8)
