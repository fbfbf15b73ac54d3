"""Segmentation metrics as confusion counts on the device.

Port of ``cp2_tpu/ops/metrics.py``: ``ConfusionState`` (the (C, C) counts
the finetune step accumulates), ``compute_metrics`` (Jaccard / Dice /
Precision / Recall / F1 under the reference's logged names, e.g.
``val_BinaryJaccardIndex``), and mmseg's ``intersect_and_union`` /
``eval_metrics``.

The counts are int64 and come from ``torch.bincount`` without weights,
which is exact and, on the card, deterministic: a pixel outside the counted
set (a padded row, a target outside ``[0, C)``) goes to one extra bin that
is thrown away.  The JAX package counts in float32, exact only up to 2²⁴
per cell; here the counts become float32 only inside ``compute_metrics``,
where the ratios are formed as the JAX function forms them.

Semantics (binary task, torchmetrics as the reference configures it):
class 1 is the positive class, ``Dice`` is the positive-class F1 and
``BinaryJaccardIndex`` TP/(TP+FP+FN).  For multiclass the ``ignore_index``
class (the background) is left out of the micro statistics.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

EPS = 1e-12


@dataclass
class ConfusionState:
    """(C, C) int64 counts; rows = target class, columns = predicted."""

    matrix: torch.Tensor

    @classmethod
    def create(cls, num_classes: int, device=None) -> "ConfusionState":
        return cls(matrix=torch.zeros((num_classes, num_classes), dtype=torch.int64,
                                      device=device))

    def update(self, preds: torch.Tensor, targets: torch.Tensor,
               sample_mask: Optional[torch.Tensor] = None) -> "ConfusionState":
        """Counts of integer prediction/target maps of one shape added.

        ``sample_mask`` (N,) bool leaves out padded rows (the loaders pad a
        short final batch by repeating its last sample)."""
        num_classes = self.matrix.shape[0]
        bins = num_classes * num_classes
        idx = targets.reshape(-1).long() * num_classes + preds.reshape(-1).long()
        keep = (idx >= 0) & (idx < bins)
        if sample_mask is not None:
            rows = sample_mask.reshape((-1,) + (1,) * (preds.dim() - 1)).expand(preds.shape)
            keep &= rows.reshape(-1)
        idx = torch.where(keep, idx, bins)
        counts = torch.bincount(idx, minlength=bins + 1)[:bins]
        return ConfusionState(matrix=self.matrix + counts.reshape(num_classes, num_classes))

    def merge(self, other: "ConfusionState") -> "ConfusionState":
        return ConfusionState(matrix=self.matrix + other.matrix)


def compute_metrics(state: ConfusionState, *, binary: bool = True,
                    ignore_index: Optional[int] = None,
                    prefix: str = "") -> Dict[str, torch.Tensor]:
    """JaccardIndex / Dice / Precision / Recall / F1Score from the counts,
    float32 scalars under the reference's key names."""
    cm = state.matrix.to(torch.float32)
    out: Dict[str, torch.Tensor] = {}

    def ratio(num, den):
        return num / torch.clamp(den, min=EPS)

    if binary:
        tp, fp, fn = cm[1, 1], cm[0, 1], cm[1, 0]
        f1 = ratio(2 * tp, 2 * tp + fp + fn)
        out[f"{prefix}BinaryJaccardIndex"] = ratio(tp, tp + fp + fn)
        out[f"{prefix}Dice"] = f1
        out[f"{prefix}BinaryPrecision"] = ratio(tp, tp + fp)
        out[f"{prefix}BinaryRecall"] = ratio(tp, tp + fn)
        out[f"{prefix}BinaryF1Score"] = f1
        return out

    num_classes = cm.shape[0]
    keep = torch.ones(num_classes, dtype=torch.bool, device=cm.device)
    if ignore_index is not None:
        keep[ignore_index] = False
    diag = torch.diagonal(cm)
    tp = torch.where(keep, diag, 0.0).sum()
    fp = torch.where(keep, cm.sum(dim=0) - diag, 0.0).sum()
    fn = torch.where(keep, cm.sum(dim=1) - diag, 0.0).sum()
    f1 = ratio(2 * tp, 2 * tp + fp + fn)
    out[f"{prefix}MulticlassJaccardIndex"] = ratio(tp, tp + fp + fn)
    out[f"{prefix}Dice"] = f1
    out[f"{prefix}MulticlassPrecision"] = ratio(tp, tp + fp)
    out[f"{prefix}MulticlassRecall"] = ratio(tp, tp + fn)
    out[f"{prefix}MulticlassF1Score"] = f1
    return out


def intersect_and_union(pred: torch.Tensor, label: torch.Tensor, num_classes: int,
                        ignore_index: Optional[int] = None):
    """Per-class intersection / union / prediction / label areas, int64
    (mmseg metrics.py:25-85)."""
    pred = pred.reshape(-1).long()
    label = label.reshape(-1).long()
    valid = torch.ones_like(label, dtype=torch.bool)
    if ignore_index is not None:
        valid = label != ignore_index

    def hist(x, mask):
        x = torch.where(mask & (x >= 0) & (x < num_classes), x, num_classes)
        return torch.bincount(x, minlength=num_classes + 1)[:num_classes]

    area_intersect = hist(pred, valid & (pred == label))
    area_pred = hist(pred, valid)
    area_label = hist(label, valid)
    return area_intersect, area_pred + area_label - area_intersect, area_pred, area_label


def eval_metrics(total_intersect, total_union, total_pred, total_label,
                 metrics=("mIoU",), beta: float = 1.0) -> Dict[str, torch.Tensor]:
    """Per-class IoU / Dice / Fscore and their means (mmseg metrics.py:133-311),
    in float32 as the JAX function computes them."""
    total_intersect, total_union, total_pred, total_label = (
        t.to(torch.float32) for t in (total_intersect, total_union, total_pred, total_label))

    def ratio(num, den):
        return num / torch.clamp(den, min=EPS)

    out: Dict[str, torch.Tensor] = {"aAcc": ratio(total_intersect.sum(), total_label.sum())}
    acc = ratio(total_intersect, total_label)
    if "mIoU" in metrics:
        iou = ratio(total_intersect, total_union)
        out.update(IoU=iou, Acc=acc, mIoU=iou.mean())
    if "mDice" in metrics:
        dice = ratio(2 * total_intersect, total_pred + total_label)
        out.update(Dice=dice, Acc=acc, mDice=dice.mean())
    if "mFscore" in metrics:
        precision = ratio(total_intersect, total_pred)
        recall = ratio(total_intersect, total_label)
        fscore = (1 + beta ** 2) * precision * recall / torch.clamp(
            beta ** 2 * precision + recall, min=EPS)
        out.update(Fscore=fscore, Precision=precision, Recall=recall, mFscore=fscore.mean())
    return out
