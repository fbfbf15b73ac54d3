"""Segmentation losses: CE, Dice, Lovász, OHEM pixel weights, accuracy.

Port of ``cp2_tpu/ops/seg_losses.py`` (mmseg's ``cross_entropy_loss.py``,
``dice_loss.py``, ``lovasz_loss.py``, ``accuracy.py`` and the OHEM pixel
sampler), registered in ``LOSSES`` under the same names.  All take NHWC
logits and (N, H, W) integer labels; ``ignore_index`` pixels weigh zero.
The TPU rewrites there (compare-and-select for gathers, key-value sorts)
are the plain ``gather`` and ``torch.sort`` here: the Lovász sum does not
depend on how ties are ordered.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from cp2_tpu_torch.models.registry import LOSSES


def _valid_mask(labels: torch.Tensor, ignore_index: Optional[int]) -> torch.Tensor:
    if ignore_index is None:
        return torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    return (labels != ignore_index).to(torch.float32)


def _pick(values: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``values[..., labels]`` per pixel; a label outside the channel range
    picks 0, as the JAX compare-and-select does."""
    classes = values.shape[-1]
    labels = labels.long()
    picked = values.gather(-1, labels.clamp(0, classes - 1)[..., None])[..., 0]
    return torch.where((labels >= 0) & (labels < classes), picked, 0.0)


def _one_hot(labels: torch.Tensor, classes: int, dtype) -> torch.Tensor:
    """One-hot by comparison (``jax.nn.one_hot``): a label outside
    ``[0, classes)`` gives a zero row, and nothing is checked on the host."""
    return (labels.long()[..., None] == torch.arange(classes, device=labels.device)).to(dtype)


def _as_tensor(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


@LOSSES.register(name="CrossEntropyLoss")
def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, *,
                       weight: Optional[torch.Tensor] = None,
                       ignore_index: Optional[int] = 255, use_sigmoid: bool = False,
                       loss_weight: float = 1.0, class_weight=None) -> torch.Tensor:
    """Pixelwise CE (or BCE when ``use_sigmoid``) with ignore handling."""
    valid = _valid_mask(labels, ignore_index)
    safe = torch.where(valid > 0, labels.long(), 0)
    if use_sigmoid:
        onehot = _one_hot(safe, logits.shape[-1], logits.dtype)
        per_class = -onehot * F.logsigmoid(logits) - (1.0 - onehot) * F.logsigmoid(-logits)
        per_pixel = per_class.mean(-1)
    else:
        per_pixel = -_pick(F.log_softmax(logits, dim=-1), safe)
        if class_weight is not None:
            per_pixel = per_pixel * _pick(
                _as_tensor(class_weight, logits).expand(*safe.shape, -1), safe)
    if weight is not None:
        per_pixel = per_pixel * weight
    return loss_weight * (per_pixel * valid).sum() / torch.clamp(valid.sum(), min=1.0)


@LOSSES.register(name="DiceLoss")
def dice_loss(logits: torch.Tensor, labels: torch.Tensor, *, smooth: float = 1.0,
              exponent: float = 2.0, ignore_index: Optional[int] = 255,
              loss_weight: float = 1.0, class_weight=None) -> torch.Tensor:
    """Multi-class soft Dice over batch and space (mmseg dice_loss.py)."""
    num_classes = logits.shape[-1]
    valid = _valid_mask(labels, ignore_index)
    probs = F.softmax(logits, dim=-1) * valid[..., None]
    onehot = _one_hot(torch.where(valid > 0, labels.long(), 0), num_classes, probs.dtype)
    onehot = onehot * valid[..., None]
    dims = tuple(range(labels.dim()))
    num = 2.0 * (probs * onehot).sum(dim=dims) + smooth
    den = (probs ** exponent).sum(dim=dims) + (onehot ** exponent).sum(dim=dims) + smooth
    per_class = 1.0 - num / den
    if class_weight is not None:
        per_class = per_class * _as_tensor(class_weight, logits)
    return loss_weight * per_class.mean()


def _lovasz_grad(gt_sorted: torch.Tensor) -> torch.Tensor:
    """Gradient of the Lovász extension with respect to sorted errors."""
    gts = gt_sorted.sum()
    intersection = gts - torch.cumsum(gt_sorted, 0)
    union = gts + torch.cumsum(1.0 - gt_sorted, 0)
    jaccard = 1.0 - intersection / torch.clamp(union, min=1e-12)
    return torch.cat([jaccard[:1], jaccard[1:] - jaccard[:-1]])


@LOSSES.register(name="LovaszLoss")
def lovasz_softmax_loss(logits: torch.Tensor, labels: torch.Tensor, *,
                        ignore_index: Optional[int] = 255, loss_weight: float = 1.0,
                        classes: str = "present") -> torch.Tensor:
    """Lovász-Softmax (mmseg lovasz_loss.py), flattened over the batch;
    ``classes="present"`` averages over the classes that appear."""
    num_classes = logits.shape[-1]
    valid = _valid_mask(labels, ignore_index).reshape(-1)
    probs = F.softmax(logits, dim=-1).reshape(-1, num_classes)
    flat = torch.where(valid > 0, labels.reshape(-1).long(), 0)
    losses, present = [], []
    for c in range(num_classes):
        fg = ((flat == c) & (valid > 0)).to(torch.float32)
        errors = (fg - probs[:, c]).abs() * valid
        errors_sorted, order = torch.sort(errors, descending=True)
        losses.append((errors_sorted * _lovasz_grad(fg[order])).sum())
        present.append((fg.sum() > 0).to(torch.float32))
    losses, present = torch.stack(losses), torch.stack(present)
    if classes == "present":
        return loss_weight * (losses * present).sum() / torch.clamp(present.sum(), min=1.0)
    return loss_weight * losses.mean()


def ohem_weights(logits: torch.Tensor, labels: torch.Tensor, *,
                 thresh: Optional[float] = None, min_kept: int = 100000,
                 ignore_index: Optional[int] = 255) -> torch.Tensor:
    """Online-hard-example pixel weights, {0, 1} float32 (OHEMPixelSampler):
    pixels whose true-class probability is at most the larger of ``thresh``
    and the ``min_kept``-th smallest such probability."""
    with torch.no_grad():
        valid = _valid_mask(labels, ignore_index)
        safe = torch.where(valid > 0, labels.long(), 0)
        conf = _pick(F.softmax(logits, dim=-1), safe)
        conf = torch.where(valid > 0, conf, float("inf"))
        flat = torch.sort(conf.reshape(-1)).values
        kth = flat[max(min(min_kept, flat.numel()) - 1, 0)]
        eff = kth if thresh is None else torch.clamp(kth, min=thresh)
        return ((conf <= eff) & (valid > 0)).to(torch.float32)


def seg_accuracy(logits: torch.Tensor, labels: torch.Tensor, *, topk=(1,),
                 ignore_index: Optional[int] = 255):
    """Pixel top-k accuracy in percent (mmseg accuracy.py).

    The label's rank is the number of channels scoring above it, plus those
    scoring equal at a lower channel: membership in a stable descending
    sort.  An ignored pixel's rank is arbitrary and weighs zero.
    """
    valid = _valid_mask(labels, ignore_index)
    cols = torch.arange(logits.shape[-1], device=logits.device)
    lab = labels.long()[..., None]
    score = torch.where(cols == lab, logits, 0).sum(dim=-1, keepdim=True)
    rank = ((logits > score) | ((logits == score) & (cols < lab))).sum(dim=-1)
    out = [100.0 * ((rank < k).to(torch.float32) * valid).sum()
           / torch.clamp(valid.sum(), min=1.0) for k in topk]
    return out[0] if len(out) == 1 else out
