"""Pixel/region correspondence math and dense-score statistics.

Port of ``cp2_tpu/ops/correlation.py`` (lines 35-240), the reference
semantics of CP2's ``tools/correlation_mapping.py``:

* ``get_correlation_map``: boolean (B, X, Y) id equality between two id
  maps, per-side match counts, and the unmasked IoU;
* ``masked_iou``: IoU over the multiset of visible ids — an id is in the
  intersection when it occurs more than once across both visible maps
  (duplicates within one map included), the union is the number of
  distinct visible ids;
* ``dense_loss_stats``: per-sample NaN-masked means and linear-law
  quartiles of the positive and negative similarity scores, with
  ``_nan_stats`` as its oracle.

Each sample's ids are sorted once and run-length boundaries count
distinct and repeated ids, with no per-sample loop and no ``unique``.
"""

from __future__ import annotations

import torch


def masked_iou(map_a: torch.Tensor, map_b: torch.Tensor, mask_a: torch.Tensor,
               mask_b: torch.Tensor) -> torch.Tensor:
    """(B,) float32 IoU between the visible id sets of (B, P) id maps.

    Ids are shifted by +1 so that a genuine id 0 counts, while masked-out
    entries become 0 and are ignored.
    """
    if map_a.dim() != 2 or mask_a.dim() != 2:
        raise ValueError(f"expected (B, P) maps/masks, got {tuple(map_a.shape)}, "
                         f"{tuple(mask_a.shape)}")
    batch = map_a.shape[0]
    zeros = torch.zeros(batch, 1, dtype=torch.float32, device=map_a.device)
    ids = torch.cat([zeros, map_a.float() + 1.0, map_b.float() + 1.0], dim=1)
    masks = torch.cat([zeros, mask_a.float(), mask_b.float()], dim=1)
    vals = torch.sort(ids * masks, dim=1).values
    # a run starts where a value differs from the one before; it holds a
    # repeat when the next value equals it (a -1 sentinel ends each row)
    sentinel = torch.full((batch, 1), -1.0, device=vals.device)
    nxt = torch.cat([vals[:, 1:], sentinel], dim=1)
    starts = torch.cat([torch.ones(batch, 1, dtype=torch.bool, device=vals.device),
                        vals[:, 1:] != vals[:, :-1]], dim=1)
    nonzero = vals > 0
    union = (starts & nonzero).sum(dim=1)
    intersection = (starts & nonzero & (nxt == vals)).sum(dim=1)
    return intersection.float() / union.clamp_min(1).float()


def get_correlation_map(map_a: torch.Tensor, map_b: torch.Tensor) -> dict:
    """Id correspondence between two (B, H, W) id maps: ``corr_map``
    (B, Ha·Wa, Hb·Wb) bool, ``corr_map_a`` / ``corr_map_b`` match counts per
    query / key, ``iou`` (B,) with every pixel visible."""
    if map_a.dim() != 3:
        raise ValueError(f"expected (B, H, W) id maps, got {tuple(map_a.shape)}")
    batch = map_a.shape[0]
    flat_a = map_a.reshape(batch, -1)
    flat_b = map_b.reshape(batch, -1)
    corr_map = flat_a[:, :, None] == flat_b[:, None, :]
    return {
        "corr_map": corr_map,
        "corr_map_a": corr_map.sum(2),
        "corr_map_b": corr_map.sum(1),
        "iou": masked_iou(flat_a, flat_b, torch.ones_like(flat_a, dtype=torch.float32),
                          torch.ones_like(flat_b, dtype=torch.float32)),
    }


def get_masked_correlation_map(map_a: torch.Tensor, map_b: torch.Tensor,
                               mask_a: torch.Tensor, mask_b: torch.Tensor) -> dict:
    """Correspondence restricted to mask-visible pixels: the raw map, its
    intersection with the outer product of the masks, the masked counts,
    and the masked IoU over visible ids."""
    batch = map_a.shape[0]
    results = get_correlation_map(map_a, map_b)
    flat_mask_a = mask_a.reshape(batch, -1).float()
    flat_mask_b = mask_b.reshape(batch, -1).float()
    pair_mask = torch.einsum("nx,ny->nxy", flat_mask_a, flat_mask_b)
    corr_mask = results["corr_map"] * pair_mask
    return {
        "corr_map": results["corr_map"],
        "corr_mask": corr_mask,
        "corr_map_a": results["corr_map_a"],
        "corr_map_a_masked": corr_mask.sum(2),
        "corr_map_b": results["corr_map_b"],
        "corr_map_b_masked": corr_mask.sum(1),
        "iou": results["iou"],
        "iou_masked": masked_iou(map_a.reshape(batch, -1), map_b.reshape(batch, -1),
                                 flat_mask_a, flat_mask_b),
    }


def _nan_stats(scores: torch.Tensor) -> dict:
    """Per-sample NaN-masked mean and quartiles of (B, X, Y) scores: the
    reference formulation, kept as the oracle of ``dense_loss_stats``."""
    average = torch.nanmean(scores, dim=(1, 2))
    flat = scores.reshape(scores.shape[0], -1)
    q = torch.nanquantile(flat, torch.tensor([0.25, 0.5, 0.75], device=flat.device),
                          dim=1)
    return {"quartiles": (q[0], q[1], q[2]), "average": average}


def _segment_quartiles(sorted_vals: torch.Tensor, start: torch.Tensor,
                       count: torch.Tensor) -> tuple:
    """Linear-law quartiles of each row's sorted segment
    ``[start, start + count)``; empty segments give NaN
    (``correlation.py:160-186``)."""
    q = torch.tensor([0.25, 0.5, 0.75], dtype=torch.float32, device=sorted_vals.device)
    cnt = count.float()[:, None]
    idx = q[None, :] * (cnt - 1.0)
    low = torch.floor(idx)
    high = torch.ceil(idx)
    high_w = idx - low
    low_w = 1.0 - high_w
    upper = torch.clamp(cnt - 1.0, min=0.0)
    low = torch.minimum(torch.clamp(low, min=0.0), upper).long()
    high = torch.minimum(torch.clamp(high, min=0.0), upper).long()
    base = start.long()[:, None]
    # an empty segment may start one past the row's end: JAX clamps such a
    # gather silently, torch raises, so clamp here (the result is NaN then)
    idx = torch.cat([base + low, base + high], dim=1).clamp(max=sorted_vals.shape[1] - 1)
    vals = sorted_vals.gather(1, idx)
    out = vals[:, :3] * low_w + vals[:, 3:] * high_w
    out = torch.where(count[:, None] > 0, out, float("nan"))
    return out[:, 0], out[:, 1], out[:, 2]


def dense_loss_stats(logits_dense: torch.Tensor, labels_dense: torch.Tensor) -> dict:
    """Positive/negative similarity statistics of (B, X, Y) dense logits
    (``correlation.py:189-240``): positives where the label is set,
    negatives elsewhere; NaN where a side is empty.

    One lexicographic sort by (label, logit) — a sort by logit, then a
    stable sort by label — orders each row as [negatives | positives],
    each ascending; the quartiles are gathers from the two segments.
    """
    if logits_dense.shape != labels_dense.shape:
        raise ValueError(f"{tuple(logits_dense.shape)} != {tuple(labels_dense.shape)}")
    b = logits_dense.shape[0]
    labels = labels_dense.reshape(b, -1).bool()
    logits = logits_dense.reshape(b, -1).float().detach()
    s = logits.shape[1]
    lab_f = labels.float()
    n_pos = lab_f.sum(dim=1)
    n_neg = s - n_pos
    sum_all = logits.sum(dim=1)
    sum_pos = (logits * lab_f).sum(dim=1)
    mean_pos = torch.where(n_pos > 0, sum_pos / n_pos.clamp_min(1.0), float("nan"))
    mean_neg = torch.where(n_neg > 0, (sum_all - sum_pos) / n_neg.clamp_min(1.0),
                           float("nan"))
    by_value, order = torch.sort(logits, dim=1)
    _, by_label = torch.sort(labels.gather(1, order).to(torch.int32), dim=1, stable=True)
    sorted_vals = by_value.gather(1, by_label)
    neg_q = _segment_quartiles(sorted_vals, torch.zeros_like(n_neg), n_neg)
    pos_q = _segment_quartiles(sorted_vals, n_neg, n_pos)
    return {
        "positive": {"quartiles": pos_q, "average": mean_pos},
        "negative": {"quartiles": neg_q, "average": mean_neg},
    }
