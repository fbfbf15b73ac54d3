"""Loss functions: InfoNCE, MoCo logits, CP2 dense loss, BYOL, segmentation
CE, negative reshaping and row quantiles.

Port of ``cp2_tpu/ops/losses.py``.  The TPU-driven rewrites there (sort-free top-k, gather-free selects) become
the plain torch calls they stand in for: ``torch.sort``, ``torch.topk``,
``gather``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from cp2_tpu_torch.parallel import concat_all_gather, world_size


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """Unit-normalize along ``dim`` (``x / max(‖x‖, eps)``)."""
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(eps)


def info_nce(pos: torch.Tensor, neg: torch.Tensor, temperature: float) -> torch.Tensor:
    """``CE(cat([pos, neg], 1) / T, zeros)``: pos (N, 1), neg (N, K)."""
    logits = torch.cat([pos, neg], dim=1) / temperature
    return -F.log_softmax(logits, dim=1)[:, 0].mean()


def moco_logits(q: torch.Tensor, k: torch.Tensor, queue: torch.Tensor):
    """(l_pos, l_neg) against the in-batch key and the (K, C) queue."""
    l_pos = torch.einsum("nc,nc->n", q, k)[:, None]
    l_neg = q @ queue.detach().T
    return l_pos, l_neg


def cp2_dense_loss(logits_dense: torch.Tensor, labels_dense: torch.Tensor,
                   temperature: float) -> torch.Tensor:
    """CP2's dense pairwise loss over (N, X, Y) logits (builder.py:1430-1437).

    The softmax runs over the QUERY axis (dim 1); the positive mass is
    averaged over foreground pairs per sample.
    """
    n = logits_dense.shape[0]
    log_sm = F.log_softmax(logits_dense / temperature, dim=1)
    labels = labels_dense.reshape(n, -1)
    num = ((-log_sm).reshape(n, -1) * labels).sum(dim=1)
    den = labels.sum(dim=1).clamp_min(1e-12)
    return (num / den).mean()


def byol_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """2 - 2·cosine similarity, per sample (reference builder.py:1080-1083)."""
    return 2.0 - 2.0 * torch.einsum("nc,nc->n", l2_normalize(x), l2_normalize(y))


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          ignore_index: Optional[int] = None,
                          sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean pixel CE of NHWC logits against integer labels (N, H, W)
    (``losses.py:78-106``).  A label outside ``[0, classes)`` picks 0, as
    the JAX compare-and-select does; ``sample_mask`` (N,) bool drops whole
    rows from the mean."""
    log_probs = F.log_softmax(logits, dim=-1)
    classes = log_probs.shape[-1]
    labels = labels.long()
    in_range = (labels >= 0) & (labels < classes)
    picked = log_probs.gather(-1, labels.clamp(0, classes - 1)[..., None])[..., 0]
    picked = torch.where(in_range, picked, 0.0)
    if ignore_index is None and sample_mask is None:
        return -picked.mean()
    valid = torch.ones_like(picked, dtype=torch.bool)
    if ignore_index is not None:
        valid &= labels != ignore_index
    if sample_mask is not None:
        valid &= sample_mask.reshape((-1,) + (1,) * (picked.dim() - 1))
    return -(picked * valid).sum() / valid.sum().clamp_min(1)


def negative_reshape(logits_dense: torch.Tensor, labels_dense: torch.Tensor,
                     negative_type: str, negative_scale: float,
                     negative_average: Optional[torch.Tensor] = None,
                     negative_median: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Post-process negative pair similarities (``losses.py:109-167``).

      FIXED:   neg -> 2·sigmoid(scale·neg) - 1
      AVERAGE: neg -> 2·sigmoid(scale·(neg - mean_neg)) - 1
      MEDIAN:  neg -> 2·sigmoid(scale·(neg - median_neg)) - 1
      HARD:    negatives above their global 75th percentile times 1.5
      NONE:    identity
    """
    is_neg = ~labels_dense.bool()

    def squash(x):
        return 2.0 / (1.0 + torch.exp(-x * negative_scale)) - 1.0

    if negative_type == "NONE":
        return logits_dense
    if negative_type == "FIXED":
        return torch.where(is_neg, squash(logits_dense), logits_dense)
    if negative_type in ("AVERAGE", "MEDIAN"):
        shift = negative_average if negative_type == "AVERAGE" else negative_median
        shift = shift.detach().reshape(-1, 1, 1)
        return torch.where(is_neg, squash(logits_dense - shift), logits_dense)
    if negative_type == "HARD":
        # the linear-law 75th percentile of the negatives: sort by value,
        # then stably by "is positive", so the negatives lead in order.  The
        # percentile is the global batch's: with more than one process it
        # is taken over every rank's rows (it only gates, no gradient)
        flat, neg = logits_dense.detach().float(), is_neg
        if world_size() > 1:
            flat = concat_all_gather(flat)
            neg = concat_all_gather(neg.float()).bool()
        flat, neg = flat.reshape(-1), neg.reshape(-1)
        by_value, order = torch.sort(flat)
        _, by_label = torch.sort((~neg[order]).to(torch.int32), stable=True)
        svals = by_value[by_label]
        n = neg.sum()
        pos = 0.75 * (n.float() - 1.0)
        low = torch.clamp(torch.floor(pos), min=0.0)
        frac = pos - low
        lo_v = svals[low.long().reshape(1)][0]
        hi_v = svals[torch.clamp(torch.ceil(pos), min=0.0).long().reshape(1)][0]
        q75 = torch.where(n > 0, lo_v * (1.0 - frac) + hi_v * frac,
                          torch.tensor(float("nan"), device=flat.device))
        hard = is_neg & (logits_dense > q75)
        return torch.where(hard, logits_dense * 1.5, logits_dense)
    raise NotImplementedError(f"negative_type={negative_type!r}")


def row_quantiles_linear(x: torch.Tensor, qs=(0.25, 0.5, 0.75)) -> torch.Tensor:
    """Per-row quantiles at static fractions, ``(len(qs), N)``
    (``losses.py:170-193``): one sort, index q·(K−1), floor/ceil blend
    ``a + (b − a)·frac`` — the law as written there, not ``torch.quantile``
    (which differs on NaN and refuses more than 2²⁴ elements)."""
    s = torch.sort(x, dim=1).values
    k = x.shape[1]
    rows = []
    for q in qs:
        pos = q * (k - 1)
        i0 = int(pos)
        i1 = min(i0 + 1, k - 1)
        frac = pos - i0
        a, b = s[:, i0], s[:, i1]
        rows.append(a + (b - a) * frac)
    return torch.stack(rows)


def topk_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                  ks: Sequence[int] = (1, 5)):
    """Top-k accuracy in percent (reference builder.py:1690-1706).

    Ties are broken in ``torch.topk``'s order, which is unspecified; the
    JAX version ranks equal scores by column.  Real logits do not tie.
    """
    top = logits.topk(max(ks), dim=1).indices
    hit = top == labels[:, None]
    return [100.0 * hit[:, :k].any(dim=1).float().mean() for k in ks]
