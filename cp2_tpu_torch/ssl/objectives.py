"""SSL objectives of the port: CP2.

Port of the CP2 part of ``cp2_tpu/ssl/objectives.py`` (reference
builder.py:1124-1606).  The dense loss goes through the hand-written
kernel's entry ``dense_pair_loss`` (CUDA tensors launch the kernel), which
equals the JAX step's ``cp2_dense_loss(einsum(q, k), a⊗b, T)`` under the
settings ``SSLHyperParams.validated()`` forces for CP2: unit
correspondence weights and ``NegativeType.NONE``.  Other weights or
negative types (PROPOSED) and the MoCo/BYOL/DenseCL objectives are not
ported yet and raise ``NotImplementedError``.

``metrics_level`` 1 adds the reference's scalar families (IoU of the
correspondence maps, dense and instance score quartiles) and 2 the
``_visual/*`` arrays of the epoch-start artifacts.  The metrics form the
(N, S², S²) similarities with their own no-grad einsum; the loss never
does.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from cp2_tpu_torch.ops.correlation import dense_loss_stats, get_masked_correlation_map
from cp2_tpu_torch.ops.dense_loss import dense_pair_loss
from cp2_tpu_torch.ops.losses import (
    l2_normalize,
    moco_logits,
    row_quantiles_linear,
    topk_accuracy,
)
from cp2_tpu_torch.ssl.hparams import SSLHyperParams
from cp2_tpu_torch.types import MappingType, NegativeType


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


def _check_supported(hp: SSLHyperParams) -> None:
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
    _check_supported(hp)
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
    if metrics_level >= 1 or epoch_scalars:
        with torch.no_grad():
            # the metrics need the (N, S², S²) logits the kernel never forms
            logits_dense = torch.einsum("nxc,nyc->nxy", q_dense, k_dense)
            labels_dense = torch.einsum("nx,ny->nxy", flat_mask_a, flat_mask_b)
            metrics = _epoch_family(loss, loss_instance, loss_dense, logits_moco,
                                    logits_dense, labels_dense, q_pos, k_pos, hp)
            if metrics_level >= 1:
                level1, ious = _level1_metrics(batch, flat_mask_a, flat_mask_b,
                                               logits_dense, labels_dense, l_pos,
                                               l_neg, hp, output_stride)
                metrics.update(level1)
            if metrics_level >= 2:
                metrics.update(_visual_arrays(batch, img_a, flat_mask_a, flat_mask_b,
                                              logits_dense, ious))
    aux = {"enqueue": {"queue": k_pos.detach()}, "metrics": metrics}
    return loss, aux


def _epoch_family(loss, loss_instance, loss_dense, logits_moco, logits_dense,
                  labels_dense, q_pos, k_pos, hp: SSLHyperParams) -> Dict[str, Any]:
    """The cheap ``train/*`` scalars the reference averages every step."""
    n = logits_moco.shape[0]
    labels_moco = torch.zeros(n, dtype=torch.long, device=logits_moco.device)
    acc1, _ = topk_accuracy(logits_moco, labels_moco, ks=(1, 5))
    top_pair = (logits_dense / hp.dense_logits_temp).reshape(n, -1).argmax(dim=1)
    hit = labels_dense.reshape(n, -1).gather(1, top_pair[:, None])
    return {
        "train/loss_step": loss.detach(),
        "train/loss_ins_step": loss_instance.detach(),
        "train/loss_dense_step": loss_dense.detach(),
        "train/acc_ins_step": acc1,
        "train/acc_seg_step": hit.mean() * 100.0,
        "train/cross_image_variance_source_step": q_pos.std(dim=0, unbiased=False).mean(),
        "train/cross_image_variance_target_step": k_pos.std(dim=0, unbiased=False).mean(),
    }


def _level1_metrics(batch, flat_mask_a, flat_mask_b, logits_dense, labels_dense,
                    l_pos, l_neg, hp: SSLHyperParams, output_stride: int):
    """IoU of the correspondence maps and the score quartiles
    (``cp2_tpu/ssl/objectives.py:117-131,237-243``).  Under
    ``MappingType.CP2`` the region ids are the pixel ids, so the region map
    is the pixel map.  Returns the metrics and the per-sample (IoU, masked
    IoU) for level 2."""
    n = flat_mask_a.shape[0]

    def grid_ids(key):
        return subsample_grid(batch[key], output_stride).float()

    def corr(prefix):
        return get_masked_correlation_map(
            grid_ids(f"{prefix}_a"), grid_ids(f"{prefix}_b"),
            flat_mask_a.reshape(n, -1), flat_mask_b.reshape(n, -1))

    region_corr = corr("pixel_ids") if hp.mapping_type == MappingType.CP2 \
        else corr("region_ids")
    out = {
        "step/average_iou": region_corr["iou"].mean(),
        "step/average_masked_iou": region_corr["iou_masked"].mean(),
    }
    out.update(_dense_stat_metrics(dense_loss_stats(logits_dense, labels_dense)))
    out.update(_instance_stat_metrics(l_pos.detach(), l_neg.detach()))
    return out, (region_corr["iou"], region_corr["iou_masked"])


def _visual_arrays(batch, img_a, flat_mask_a, flat_mask_b, logits_dense, ious):
    """Array payloads of the epoch-start artifacts
    (``cp2_tpu/ssl/objectives.py:245-259``); the CLI renders them."""
    img_b, _ = composite_foreground(batch["img_b"], batch["bg1"])
    return {
        "_visual/logits_dense": logits_dense,
        "_visual/mask_a": flat_mask_a,
        "_visual/mask_b": flat_mask_b,
        "_visual/img_a": img_a.detach(),
        "_visual/img_b": img_b,
        "_visual/ious": ious[0],
        "_visual/ious_masked": ious[1],
    }


def _instance_stat_metrics(l_pos, l_neg):
    q = row_quantiles_linear(l_neg, (0.25, 0.5, 0.75))
    return {
        "step/instance_average_positive_scores": l_pos.mean(),
        "step/instance_average_negative_scores": l_neg.mean(),
        "step/instance_lower_negative_scores": q[0].mean(),
        "step/instance_median_negative_scores": q[1].mean(),
        "step/instance_upper_negative_scores": q[2].mean(),
    }


def _dense_stat_metrics(stats):
    out = {}
    for side in ("positive", "negative"):
        avg = stats[side]["average"]
        lo, med, hi = stats[side]["quartiles"]
        out[f"step/dense_per_sample_average_{side}_scores"] = torch.nanmean(avg)
        out[f"step/dense_per_sample_lower_{side}_scores"] = torch.nanmean(lo)
        out[f"step/dense_per_sample_median_{side}_scores"] = torch.nanmean(med)
        out[f"step/dense_per_sample_upper_{side}_scores"] = torch.nanmean(hi)
    out["train/+ive_scores_step"] = torch.nanmean(stats["positive"]["average"])
    out["train/-ive_scores_step"] = torch.nanmean(stats["negative"]["average"])
    return out


@torch.no_grad()
def cp2_key_forward(ema_model, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Key-encoder dense forward on the composited img_b, train-mode BN."""
    img_b, _ = composite_foreground(batch["img_b"], batch["bg1"])
    return ema_model.dense(img_b)
