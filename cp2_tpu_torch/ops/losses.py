"""Loss functions of the CP2 path: InfoNCE, MoCo logits, CP2 dense loss.

Port of the CP2 subset of ``cp2_tpu/ops/losses.py``.  The TPU-driven
rewrites there (sort-free top-k, gather-free selects) become the plain
torch calls they stand in for.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


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


def topk_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                  ks: Sequence[int] = (1, 5)):
    """Top-k accuracy in percent (reference builder.py:1690-1706).

    Ties are broken in ``torch.topk``'s order, which is unspecified; the
    JAX version ranks equal scores by column.  Real logits do not tie.
    """
    top = logits.topk(max(ks), dim=1).indices
    hit = top == labels[:, None]
    return [100.0 * hit[:, :k].any(dim=1).float().mean() for k in ks]
