"""SSL objectives of the port: CP2.

Port of the CP2 part of ``cp2_tpu/ssl/objectives.py`` (reference
builder.py:1124-1606).  The dense loss goes through the hand-written
kernel's entry ``dense_pair_loss`` (CUDA tensors launch the kernel), which
equals the JAX step's ``cp2_dense_loss(einsum(q, k), a⊗b, T)`` under the
settings ``SSLHyperParams.validated()`` forces for CP2: unit
correspondence weights and ``NegativeType.NONE``.  Other weights or
negative types (PROPOSED), the correspondence/IoU metrics of
``metrics_level >= 1`` and the MoCo/BYOL/DenseCL objectives are not ported
yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from cp2_tpu_torch.ops.dense_loss import dense_pair_loss
from cp2_tpu_torch.ops.losses import l2_normalize, moco_logits, topk_accuracy
from cp2_tpu_torch.ssl.hparams import SSLHyperParams
from cp2_tpu_torch.types import NegativeType


def subsample_grid(x: torch.Tensor, stride: int) -> torch.Tensor:
    """Strided half-offset subsample of (N, H, W, ...) to the feature grid
    (builder.py:1155-1186)."""
    return x[:, stride // 2 :: stride, stride // 2 :: stride]


def composite_foreground(img: torch.Tensor, bg: torch.Tensor):
    """Copy-paste: foreground shows through where bg was erased to zero.

    The background stream erased a random rectangle to exactly 0; the mask
    is re-derived from channel 0 (builder.py:1146-1152).  NHWC in, returns
    (composited image, (N, H, W) foreground mask).
    """
    mask = (bg[..., 0] == 0).to(img.dtype)
    return img * mask[..., None] + bg, mask


def _check_supported(hp: SSLHyperParams, metrics_level: int) -> None:
    unit_weights = (
        hp.lmbd_pixel_corr_weight == 1
        and hp.lmbd_region_corr_weight == 1
        and hp.lmbd_not_corr_weight == 1
    )
    if not unit_weights or hp.negative_type != NegativeType.NONE:
        raise NotImplementedError(
            "correspondence weights and negative reshaping (PROPOSED) are not "
            "ported yet: the dense kernel covers unit weights, NegativeType.NONE"
        )
    if metrics_level >= 1:
        raise NotImplementedError(
            "metrics_level >= 1 needs the correspondence/IoU and quartile "
            "metrics (cp2_tpu/ops/correlation.py), not ported yet"
        )


def cp2_objective(
    model,
    key_feats: torch.Tensor,
    batch: Dict[str, torch.Tensor],
    queue: torch.Tensor,
    hp: SSLHyperParams,
    output_stride: int,
    *,
    metrics_level: int = 0,
    epoch_scalars: bool = False,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Dense + instance contrastive loss on composited crops.

    ``model`` is the query encoder in train mode (its BatchNorm buffers
    update in place); ``key_feats`` the key encoder's dense output on the
    composited img_b, without grad.  ``epoch_scalars`` computes the cheap
    ``train/*`` family (the reference's per-step epoch aggregates).
    Returns ``(loss, aux)``; aux holds ``enqueue`` and ``metrics``.
    """
    _check_supported(hp, metrics_level)
    img_a, mask_a_full = composite_foreground(batch["img_a"], batch["bg0"])
    _, mask_b_full = composite_foreground(batch["img_b"], batch["bg1"])
    n = img_a.shape[0]
    flat_mask_a = subsample_grid(mask_a_full, output_stride).reshape(n, -1)
    flat_mask_b = subsample_grid(mask_b_full, output_stride).reshape(n, -1)

    # query path (builder.py:1259-1268)
    q_out = model.dense(img_a)
    s2 = q_out.shape[1] * q_out.shape[2]
    q_dense = l2_normalize(q_out.reshape(n, s2, -1).float())
    q_pos = l2_normalize(torch.einsum("nxc,nx->nc", q_dense, flat_mask_a))

    # key path outputs, pre-computed (builder.py:1271-1285)
    k_dense = l2_normalize(key_feats.reshape(n, s2, -1).float()).detach()
    k_pos = l2_normalize(torch.einsum("nxc,nx->nc", k_dense, flat_mask_b))

    # dense pairwise loss (builder.py:1289,1430-1437) on the kernel
    loss_dense = dense_pair_loss(q_dense, k_dense, flat_mask_a, flat_mask_b,
                                 hp.dense_logits_temp)

    # instance (MoCo) logits against the queue (builder.py:1394-1423)
    l_pos, l_neg = moco_logits(q_pos, k_pos, queue)
    cols = [l_pos, l_neg]
    if hp.include_background:
        q_neg = l2_normalize(torch.einsum("nxc,nx->nc", q_dense, 1.0 - flat_mask_a))
        k_neg = l2_normalize(torch.einsum("nxc,nx->nc", k_dense, 1.0 - flat_mask_b))
        cols.append(torch.einsum("nc,nc->n", q_pos, q_neg)[:, None])
        cols.append(torch.einsum("nc,nc->n", q_pos, k_neg)[:, None])
    logits_moco = torch.cat(cols, dim=1) / hp.instance_logits_temp
    loss_instance = -F.log_softmax(logits_moco, dim=1)[:, 0].mean()
    loss = loss_instance + loss_dense * hp.lmbd_cp2_dense_loss

    metrics: Dict[str, torch.Tensor] = {}
    if epoch_scalars:
        with torch.no_grad():
            labels_moco = torch.zeros(n, dtype=torch.long, device=q_pos.device)
            acc1, _ = topk_accuracy(logits_moco, labels_moco, ks=(1, 5))
            # the metric needs the (N, S², S²) logits the kernel never forms
            logits_dense = torch.einsum("nxc,nyc->nxy", q_dense, k_dense)
            labels_dense = torch.einsum("nx,ny->nxy", flat_mask_a, flat_mask_b)
            top_pair = (logits_dense / hp.dense_logits_temp).reshape(n, -1).argmax(dim=1)
            hit = labels_dense.reshape(n, -1).gather(1, top_pair[:, None])
            metrics = {
                "train/loss_step": loss.detach(),
                "train/loss_ins_step": loss_instance.detach(),
                "train/loss_dense_step": loss_dense.detach(),
                "train/acc_ins_step": acc1,
                "train/acc_seg_step": hit.mean() * 100.0,
                "train/cross_image_variance_source_step":
                    q_pos.std(dim=0, unbiased=False).mean(),
                "train/cross_image_variance_target_step":
                    k_pos.std(dim=0, unbiased=False).mean(),
            }
    aux = {"enqueue": {"queue": k_pos.detach()}, "metrics": metrics}
    return loss, aux


@torch.no_grad()
def cp2_key_forward(ema_model, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Key-encoder dense forward on the composited img_b, train-mode BN."""
    img_b, _ = composite_foreground(batch["img_b"], batch["bg1"])
    return ema_model.dense(img_b)
