"""Resizing ops with the JAX package's semantics, on NHWC tensors.

Port of ``cp2_tpu/ops/resize.py``:

* ``resize_bilinear`` is ``jax.image.resize(method="linear")``: half-pixel
  centres (torch ``align_corners=False``) and, when it downsamples, a
  triangle kernel widened by the scale, an antialiasing low-pass that
  ``F.interpolate`` does not apply.  The (out, in) weights of each axis are
  built as ``jax.image.scale_and_translate`` builds them (its
  ``compute_weight_mat``) and applied as two products, rows then columns,
  so both directions equal JAX's.  Upsampling, the only direction the
  finetune path takes (22² → 352² logits), agrees with ``F.interpolate``.
* ``nearest_exact_resize`` reproduces cv2.INTER_NEAREST_EXACT: the source
  index of output cell i is ``floor((i + 0.5) * src/dst)``.
* ``rescale_ids`` strided id subsampling (reference ``loader.py:39-43``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def rescale_ids(pixel_ids: torch.Tensor, stride: int) -> torch.Tensor:
    """Subsample an id map with half-stride offset (reference loader.py:39-43)."""
    return pixel_ids[..., stride // 2::stride, stride // 2::stride]


def _nearest_exact_indices(dst_size: int, src_size: int, device) -> torch.Tensor:
    """Source indices for half-pixel-centre nearest sampling."""
    scale = src_size / dst_size
    idx = torch.floor((torch.arange(dst_size, dtype=torch.float32, device=device) + 0.5)
                      * scale)
    return idx.to(torch.int32).clamp(0, src_size - 1).long()


def nearest_exact_resize(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest-exact resize of the trailing two dims of ``x`` ((H, W),
    (B, H, W) or (..., H, W), any dtype): integer id maps never blend."""
    rows = _nearest_exact_indices(out_hw[0], x.shape[-2], x.device)
    cols = _nearest_exact_indices(out_hw[1], x.shape[-1], x.device)
    return x[..., rows[:, None], cols[None, :]]


def linear_weights(in_size: int, out_size: int, device=None) -> torch.Tensor:
    """(out, in) float32 weights of ``jax.image.resize(method="linear")``
    along one axis: scale ``out/in``, no translation, antialiased.

    The triangle kernel is widened by ``max(in/out, 1)``, normalised over the
    taps in range, and zero where the sample lies outside ``[-0.5, in - 0.5]``.
    """
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = ((torch.arange(out_size, dtype=torch.float32, device=device) + 0.5)
                * inv_scale - 0.5)
    src = torch.arange(in_size, dtype=torch.float32, device=device)
    x = (sample_f[:, None] - src[None, :]).abs() / kernel_scale
    weights = torch.clamp(1.0 - x, min=0.0)
    total = weights.sum(dim=1, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, None], weights, 0.0)


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize (half-pixel centres) of an NHWC tensor, JAX's
    ``jax.image.resize(method="linear")`` in both directions.  An axis whose
    size does not change is left as it is, as JAX skips it."""
    if x.dim() != 4:
        raise ValueError(f"expected NHWC, got {tuple(x.shape)}")
    if not x.is_floating_point():
        x = x.float()
    h, w = x.shape[1], x.shape[2]
    if h != out_hw[0]:
        wy = linear_weights(h, out_hw[0], x.device).to(x.dtype)
        x = torch.einsum("oh,nhwc->nowc", wy, x)
    if w != out_hw[1]:
        wx = linear_weights(w, out_hw[1], x.device).to(x.dtype)
        x = torch.einsum("pw,nowc->nopc", wx, x)
    return x


def _nearest_indices(dst_size: int, src_size: int, device) -> torch.Tensor:
    """``jax.image.resize(method="nearest")``'s indices:
    ``floor((i + 0.5) * src / dst)``."""
    idx = torch.floor((torch.arange(dst_size, dtype=torch.float32, device=device) + 0.5)
                      * src_size / dst_size)
    return idx.long()


def resize(x: torch.Tensor, size: Optional[Tuple[int, int]] = None,
           scale_factor: Optional[float] = None, mode: str = "bilinear",
           align_corners: bool = False) -> torch.Tensor:
    """mmseg's ``resize`` wrapper on NHWC (mmseg_/ops/wrappers.py:7-27).

    ``align_corners=True`` maps, as in the JAX package, to JAX's "triangle"
    method, which is its linear kernel: both settings give
    :func:`resize_bilinear`.
    """
    del align_corners  # one kernel either way (see above)
    if size is None:
        size = (int(x.shape[1] * scale_factor), int(x.shape[2] * scale_factor))
    if mode in ("bilinear", "linear"):
        return resize_bilinear(x, size)
    if mode == "nearest":
        if x.dim() == 4:
            return nearest_exact_resize(x.permute(0, 3, 1, 2), size).permute(0, 2, 3, 1)
        return nearest_exact_resize(x, size)
    raise ValueError(mode)


def upsample(x: torch.Tensor, scale_factor: int = 2, mode: str = "nearest") -> torch.Tensor:
    """mmseg ``Upsample`` module equivalent (wrappers.py:29), NHWC."""
    n, h, w, c = x.shape
    out_h, out_w = h * scale_factor, w * scale_factor
    if mode != "nearest":
        return resize_bilinear(x, (out_h, out_w))
    rows = _nearest_indices(out_h, h, x.device)
    cols = _nearest_indices(out_w, w, x.device)
    return x[:, rows[:, None], cols[None, :]]
