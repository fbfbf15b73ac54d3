"""SSL objectives of the port: CP2 / PROPOSED, MoCo-v2, BYOL, DenseCL /
PROPOSED_V2.

Port of ``cp2_tpu/ssl/objectives.py`` (reference builder.py:651-1606).
Each objective takes the query encoder in train mode (its BatchNorm
buffers update in place, in the JAX call order) and the key encoder's
outputs, computed without grad, and returns ``(loss, aux)``; aux holds
``enqueue`` (the keys for ``queue`` and/or ``queue2``) and ``metrics``.

How the CP2/PROPOSED dense loss is routed.  The hand-written kernel
(``ops/dense_loss.py::dense_pair_loss``) computes one function: the
mask-outer-product loss with unit weights, ``cp2_dense_loss(einsum(q, k),
a⊗b, T)`` (``cp2_tpu/ops/pallas/dense_loss.py:31-39,271-275``).
PROPOSED's general loss is another function: it reshapes the negatives
(``objectives.py:196-203``) and multiplies the logits by correspondence
weights (``:204-205``) before ``cp2_dense_loss`` (``:217``), which the
JAX package computes with an XLA einsum (``:187``), never with the
kernel.  So ``cp2_objective`` takes the kernel exactly when the
hyperparameters make the two functions one — all three correspondence
weights 1 and ``NegativeType.NONE`` (CP2, and PROPOSED run that way;
``uses_dense_kernel``) — and otherwise runs the JAX formula in plain
torch: einsum → ``negative_reshape`` → ``* corr_weights`` →
``cp2_dense_loss``.  The choice is made from ``hp`` alone, before any
tensor is touched; nothing is caught and nothing retried.

``metrics_level`` 1 adds the reference's scalar families (IoU of the
correspondence maps, dense and instance score quartiles, DenseCL's
matching rates) and 2 the ``_visual/*`` arrays of the epoch-start
artifacts (CP2/PROPOSED).  On the kernel route the metrics form the
(N, S², S²) similarities with their own no-grad einsum.  On the plain
route the accuracy and the visuals read the reshaped, weighted logits
and the dense statistics the raw ones, as in the JAX objective.

With more than one process each rank holds its rows of the global batch.
The losses are means over the rows, so the mean of the ranks' losses is
the global loss; the statistics that mix rows are taken on every rank's
rows (``concat_all_gather``): the cross-image std, the NaN-skipping means
of the dense score statistics, and DenseCL's matching rate (its counts
summed), as global-view ``jit`` takes them over the global batch.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from cp2_tpu_torch.ops.correlation import (
    dense_loss_stats,
    get_correlation_map,
    get_masked_correlation_map,
)
from cp2_tpu_torch.ops.dense_loss import dense_pair_loss
from cp2_tpu_torch.ops.losses import (
    byol_loss,
    cp2_dense_loss,
    info_nce,
    l2_normalize,
    moco_logits,
    negative_reshape,
    row_quantiles_linear,
    topk_accuracy,
)
from cp2_tpu_torch.parallel import concat_all_gather, psum_metrics, world_size
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


# ---------------------------------------------------------------------------
# CP2 / PROPOSED
# ---------------------------------------------------------------------------

def unit_weights(hp: SSLHyperParams) -> bool:
    return (hp.lmbd_pixel_corr_weight == 1 and hp.lmbd_region_corr_weight == 1
            and hp.lmbd_not_corr_weight == 1)


def uses_dense_kernel(hp: SSLHyperParams) -> bool:
    """Whether ``cp2_objective`` takes the dense-loss kernel (see the module
    docstring): unit correspondence weights and no negative reshaping."""
    return unit_weights(hp) and hp.negative_type == NegativeType.NONE


def correspondence_weights(hp: SSLHyperParams, pixel_ids_a, pixel_ids_b,
                           region_ids_a, region_ids_b) -> torch.Tensor:
    """(N, S², S²) weights of PROPOSED's dense logits from (N, S²) id maps
    (``cp2_tpu/ssl/objectives.py:132-145``, builder.py:1204-1243): the
    region weight where the region ids agree and both are known (SAM id 0
    is unknown), the pixel weight where the pixel ids agree, and the
    not-corresponding weight where neither set a weight."""
    pixel_map = pixel_ids_a[:, :, None] == pixel_ids_b[:, None, :]
    if hp.mapping_type == MappingType.CP2:
        region_map = pixel_map  # region ids are the pixel ids (loader.py:84-85)
    else:
        region_map = region_ids_a[:, :, None] == region_ids_b[:, None, :]
    known = (region_ids_a != 0)[:, :, None] & (region_ids_b != 0)[:, None, :]
    weights = hp.lmbd_region_corr_weight * (region_map & known).float()
    weights = torch.where(pixel_map, float(hp.lmbd_pixel_corr_weight), weights)
    return weights + (weights == 0) * hp.lmbd_not_corr_weight


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

    ``key_feats`` is the key encoder's dense output on the composited
    img_b, without grad.  ``epoch_scalars`` computes the cheap ``train/*``
    family (the reference's per-step epoch aggregates).
    """
    img_a, mask_a_full = composite_foreground(batch["img_a"], batch["bg0"])
    _, mask_b_full = composite_foreground(batch["img_b"], batch["bg1"])
    n = img_a.shape[0]
    flat_mask_a = subsample_grid(mask_a_full, output_stride).reshape(n, -1)
    flat_mask_b = subsample_grid(mask_b_full, output_stride).reshape(n, -1)

    def grid_ids(key):
        return subsample_grid(batch[key], output_stride)

    corr_weights = None
    if not unit_weights(hp):
        with torch.no_grad():
            corr_weights = correspondence_weights(
                hp, *(grid_ids(k).reshape(n, -1) for k in (
                    "pixel_ids_a", "pixel_ids_b", "region_ids_a", "region_ids_b")))

    # query path (builder.py:1259-1268)
    q_out = model.dense(img_a)
    s2 = q_out.shape[1] * q_out.shape[2]
    q_dense = l2_normalize(q_out.reshape(n, s2, -1).float())
    q_pos = l2_normalize(torch.einsum("nxc,nx->nc", q_dense, flat_mask_a))

    # key path outputs, pre-computed (builder.py:1271-1285)
    k_dense = l2_normalize(key_feats.reshape(n, s2, -1).float()).detach()
    k_pos = l2_normalize(torch.einsum("nxc,nx->nc", k_dense, flat_mask_b))

    # dense pairwise loss (builder.py:1289-1437), routed as the module
    # docstring says
    logits_dense = stats = None
    if uses_dense_kernel(hp):
        loss_dense = dense_pair_loss(q_dense, k_dense, flat_mask_a, flat_mask_b,
                                     hp.dense_logits_temp)
    else:
        logits_dense = torch.einsum("nxc,nyc->nxy", q_dense, k_dense)
        labels_dense = torch.einsum("nx,ny->nxy", flat_mask_a, flat_mask_b)
        if metrics_level >= 1 or hp.negative_type in (NegativeType.AVERAGE,
                                                      NegativeType.MEDIAN):
            with torch.no_grad():
                stats = dense_loss_stats(logits_dense, labels_dense)
        logits_dense = negative_reshape(
            logits_dense, labels_dense, hp.negative_type.name, hp.negative_scale,
            negative_average=None if stats is None else stats["negative"]["average"],
            negative_median=None if stats is None else stats["negative"]["quartiles"][1],
        )
        if corr_weights is not None:
            logits_dense = logits_dense * corr_weights
        loss_dense = cp2_dense_loss(logits_dense, labels_dense, hp.dense_logits_temp)

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
            if logits_dense is None:  # the kernel never forms the logits
                logits_dense = torch.einsum("nxc,nyc->nxy", q_dense, k_dense)
            logits_dense = logits_dense.detach()
            labels_dense = torch.einsum("nx,ny->nxy", flat_mask_a, flat_mask_b)
            metrics = _epoch_family(loss, loss_instance, loss_dense, logits_moco,
                                    logits_dense, labels_dense, q_pos, k_pos, hp)
            if metrics_level >= 1:
                # the raw logits' statistics: on the kernel route the
                # logits are raw, on the plain route they were taken above
                if stats is None:
                    stats = dense_loss_stats(logits_dense, labels_dense)
                ids = "pixel_ids" if hp.mapping_type == MappingType.CP2 else "region_ids"
                region_corr = get_masked_correlation_map(
                    grid_ids(f"{ids}_a").float(), grid_ids(f"{ids}_b").float(),
                    flat_mask_a, flat_mask_b)
                metrics["step/average_iou"] = region_corr["iou"].mean()
                metrics["step/average_masked_iou"] = region_corr["iou_masked"].mean()
                metrics.update(_dense_stat_metrics(stats))
                metrics.update(_instance_stat_metrics(l_pos.detach(), l_neg.detach()))
            if metrics_level >= 2:
                metrics.update(_visual_arrays(batch, img_a, flat_mask_a, flat_mask_b,
                                              logits_dense, region_corr))
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
        **dict(zip(("train/cross_image_variance_source_step",
                    "train/cross_image_variance_target_step"),
                   _cross_image_variances(q_pos, k_pos))),
    }


def _cross_image_variances(q: torch.Tensor, k: torch.Tensor):
    """The mean over channels of the std across the batch of ``q`` and of
    ``k`` (N, C): over the global batch, whose rows one ``concat_all_gather``
    brings to every rank."""
    if world_size() > 1:
        both = concat_all_gather(torch.cat([q, k], dim=1))
        q, k = both[:, :q.shape[1]], both[:, q.shape[1]:]
    return q.std(dim=0, unbiased=False).mean(), k.std(dim=0, unbiased=False).mean()


def _visual_arrays(batch, img_a, flat_mask_a, flat_mask_b, logits_dense, region_corr):
    """Array payloads of the epoch-start artifacts
    (``cp2_tpu/ssl/objectives.py:245-259``); the CLI renders them."""
    img_b, _ = composite_foreground(batch["img_b"], batch["bg1"])
    return {
        "_visual/logits_dense": logits_dense,
        "_visual/mask_a": flat_mask_a,
        "_visual/mask_b": flat_mask_b,
        "_visual/img_a": img_a.detach(),
        "_visual/img_b": img_b,
        "_visual/ious": region_corr["iou"],
        "_visual/ious_masked": region_corr["iou_masked"],
    }


@torch.no_grad()
def cp2_key_forward(ema_model, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Key-encoder dense forward on the composited img_b, train-mode BN."""
    img_b, _ = composite_foreground(batch["img_b"], batch["bg1"])
    return ema_model.dense(img_b)


# ---------------------------------------------------------------------------
# MoCo-v2
# ---------------------------------------------------------------------------

@torch.no_grad()
def moco_key_forward(ema_model, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    return l2_normalize(ema_model.global_embed(batch["img_b"]).float())


def moco_objective(model, key_embed: torch.Tensor, batch, queue: torch.Tensor,
                   hp: SSLHyperParams, *, metrics_level: int = 0,
                   epoch_scalars: bool = False):
    """Image-level InfoNCE against the queue (builder.py:1001-1077)."""
    q = l2_normalize(model.global_embed(batch["img_a"]).float())
    l_pos, l_neg = moco_logits(q, key_embed, queue)
    logits = torch.cat([l_pos, l_neg], dim=1) / hp.instance_logits_temp
    loss = -F.log_softmax(logits, dim=1)[:, 0].mean()

    metrics = {}
    if metrics_level >= 1 or epoch_scalars:
        with torch.no_grad():
            labels = torch.zeros(q.shape[0], dtype=torch.long, device=q.device)
            acc1, _ = topk_accuracy(logits, labels, ks=(1, 5))
            metrics = {"train/loss_step": loss.detach(), "train/acc_ins_step": acc1}
            if metrics_level >= 1:
                metrics.update(_instance_stat_metrics(l_pos.detach(), l_neg.detach()))
    return loss, {"enqueue": {"queue": key_embed}, "metrics": metrics}


# ---------------------------------------------------------------------------
# BYOL
# ---------------------------------------------------------------------------

@torch.no_grad()
def byol_key_forward(ema_model, batch: Dict[str, torch.Tensor]):
    """EMA targets of both views; the key BatchNorm chains img_a → img_b."""
    return tuple(ema_model.global_embed(batch[key]).float() for key in ("img_a", "img_b"))


def byol_objective(model, key_embeds, batch, hp: SSLHyperParams, *,
                   metrics_level: int = 0, epoch_scalars: bool = False):
    """Symmetric predictor regression to the EMA targets
    (builder.py:1079-1122).  The online BatchNorms chain projector →
    predictor on img_a, then on img_b."""
    del hp
    k_a, k_b = key_embeds
    q_a = model.predict(model.global_embed(batch["img_a"])).float()
    q_b = model.predict(model.global_embed(batch["img_b"])).float()
    loss = (byol_loss(q_a, k_b) + byol_loss(q_b, k_a)).mean()
    metrics = ({"train/loss_step": loss.detach()}
               if metrics_level >= 1 or epoch_scalars else {})
    return loss, {"enqueue": {}, "metrics": metrics}


# ---------------------------------------------------------------------------
# DenseCL / PROPOSED_V2
# ---------------------------------------------------------------------------

@torch.no_grad()
def densecl_key_forward(ema_model, img: torch.Tensor):
    """Key projections of one image batch: (neck outputs, last stage).

    The symmetric loss runs it on img_b, then — after the train step's
    second EMA update (builder.py:723-726,944-948) — on img_a."""
    return ema_model.densecl_embed(img)


def _densecl_normalize(proj: dict, embd: torch.Tensor, use_predictor: bool,
                       use_avgpool_global: bool, is_key: bool):
    """Select + normalize the global/local projections (builder.py:700-758).

    Local maps are NHWC, so ``reshape(n, -1, C)`` orders the grid as the
    flax objective does."""
    n = embd.shape[0]
    if is_key:
        local = proj["x_local_proj"]
        glob = proj["x_avgpool_local_proj"] if use_avgpool_global else proj["x_global_proj"]
    else:
        local = proj["x_local_pred"] if use_predictor else proj["x_local_proj"]
        if use_avgpool_global:
            glob = proj["x_avgpool_local_pred"] if use_predictor else proj["x_avgpool_local_proj"]
        else:
            glob = proj["x_global_pred"] if use_predictor else proj["x_global_proj"]
    c = local.shape[-1]
    local = l2_normalize(local.reshape(n, -1, c).float())  # (N, S², C)
    glob = l2_normalize(glob.float())
    embd_n = l2_normalize(embd.reshape(n, -1, embd.shape[-1]).float())
    pooled = l2_normalize(proj["x_local_proj"].reshape(n, -1, c).mean(dim=1).float())
    return glob, local, embd_n, pooled


def densecl_objective(
    model,
    key_outs: Sequence[Tuple[dict, torch.Tensor]],
    batch: Dict[str, torch.Tensor],
    queues: Tuple[torch.Tensor, torch.Tensor],
    hp: SSLHyperParams,
    backbone_output_stride: int,
    step: int,
    *,
    metrics_level: int = 0,
    epoch_scalars: bool = False,
):
    """Global + dense InfoNCE with similarity/coordinate positive matching
    (reference builder.py:667-999).  ``queues`` is (queue, queue2);
    ``step`` the state's step before this one, whose parity picks the
    symmetric loss's enqueue source (builder.py:966-972)."""
    queue, queue2 = queues
    bos = backbone_output_stride
    pixel_ids_a = subsample_grid(batch["pixel_ids_a"], bos).float()
    pixel_ids_b = subsample_grid(batch["pixel_ids_b"], bos).float()

    def local_loss(q_embd, k_embd, q_local, k_local, ids_q, ids_k, log_metrics):
        # similarity-based positive matching (builder.py:817-835)
        with torch.no_grad():
            pos_idx = torch.einsum("nxc,nyc->nxy", q_embd, k_embd).argmax(dim=2)
        local_sim = torch.einsum("nxc,nyc->nxy", q_local, k_local)
        pos_local = local_sim.gather(2, pos_idx[..., None])[..., 0]

        # coordinate ground-truth blending (builder.py:838-855)
        n, s2, c = q_local.shape
        corr_map = (ids_q.reshape(n, -1)[:, :, None]
                    == ids_k.reshape(n, -1)[:, None, :]).float()
        overlap = corr_map.sum(-1) > 0
        coord_scores = (local_sim * corr_map).sum(-1)
        pos_local = torch.where(
            overlap,
            pos_local * (1.0 - hp.lmbd_coordinate) + coord_scores * hp.lmbd_coordinate,
            pos_local,
        )

        q_flat = q_local.reshape(n * s2, c)
        pos_flat = pos_local.reshape(n * s2, 1)
        neg_flat = q_flat @ queue2.detach().T
        loss = info_nce(pos_flat, neg_flat, hp.dense_logits_temp)

        m = {}
        if log_metrics and metrics_level >= 1:
            with torch.no_grad():
                # diagnostic: argmax(sim) == argmax(coord) on overlap pixels
                match = (corr_map.argmax(dim=2) == local_sim.argmax(dim=2)) & overlap
                n_overlap = overlap.sum()
                iou = get_correlation_map(ids_q, ids_k)["iou"]
                m = {
                    "step/average_iou": iou.mean(),
                    "step/non_zero_iou_ratio": (iou > 0).float().mean(),
                    "step/matching_positives_rate": _global_rate(match.sum(), n_overlap),
                    "step/dense_average_positive_scores": pos_flat.mean(),
                    "step/dense_average_negative_scores": neg_flat.mean(),
                }
        return loss, m

    def direction(img, key_out, ids_q, ids_k, log_metrics):
        """One query image against the other's keys: a dict of the global
        and local losses, the local metrics and what the caller reads."""
        proj, embd = model.densecl_embed(img)
        qg, ql, qe, _ = _densecl_normalize(proj, embd, hp.use_predictor,
                                           hp.use_avgpool_global, is_key=False)
        kg, kl, ke, kpool = _densecl_normalize(*key_out, hp.use_predictor,
                                               hp.use_avgpool_global, is_key=True)
        l_pos, l_neg = moco_logits(qg, kg, queue)
        loss_local, m = local_loss(qe, ke, ql, kl, ids_q, ids_k, log_metrics)
        return dict(loss_global=info_nce(l_pos, l_neg, hp.instance_logits_temp),
                    loss_local=loss_local, metrics=m, qg=qg, kg=kg, kpool=kpool,
                    l_pos=l_pos, l_neg=l_neg)

    # direction 1: a -> b
    d1 = direction(batch["img_a"], key_outs[0], pixel_ids_a, pixel_ids_b, True)
    loss_global, loss_local = d1["loss_global"], d1["loss_local"]
    enqueue_g, enqueue_l = d1["kg"], d1["kpool"]
    if hp.use_symmetrical_loss:
        d2 = direction(batch["img_b"], key_outs[1], pixel_ids_b, pixel_ids_a, False)
        loss_global = loss_global + d2["loss_global"]
        loss_local = loss_local + d2["loss_local"]
        # alternate queue source by step parity (builder.py:966-972)
        if step % 2 == 0:
            enqueue_g, enqueue_l = d2["kg"], d2["kpool"]

    loss = (1.0 - hp.lmbd_cp2_dense_loss) * loss_global + hp.lmbd_cp2_dense_loss * loss_local

    metrics = {}
    if metrics_level >= 1 or epoch_scalars:
        with torch.no_grad():
            metrics = {
                "train/loss_step": loss.detach(),
                "train/loss_ins_step": loss_global.detach(),
                "train/loss_dense_step": loss_local.detach(),
                **dict(zip(("step/cross_image_variance_source_step",
                            "step/cross_image_variance_target_step"),
                           _cross_image_variances(d1["qg"], d1["kg"]))),
            }
            if metrics_level >= 1:
                metrics.update(d1["metrics"])
                metrics.update(_instance_stat_metrics(d1["l_pos"].detach(),
                                                      d1["l_neg"].detach()))
    return loss, {"enqueue": {"queue": enqueue_g, "queue2": enqueue_l},
                  "metrics": metrics}


# ---------------------------------------------------------------------------
# metric helpers
# ---------------------------------------------------------------------------

def _global_rate(hits: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """``hits / total`` over the global batch (-1 where ``total`` is 0):
    both counts summed over the ranks first."""
    if world_size() > 1:
        sums = psum_metrics({"hits": hits, "total": total})
        hits, total = sums["hits"], sums["total"]
    return torch.where(total > 0, hits / total.clamp_min(1), -1.0)


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
    """Means over the samples of per-sample statistics, NaN (an empty side)
    left out.  With more than one process the per-sample values of every
    rank are gathered first: a mean of the ranks' means would weigh each
    rank's samples by how many of them are not NaN."""
    def nanmean(x):
        return torch.nanmean(concat_all_gather(x) if world_size() > 1 else x)

    out = {}
    for side in ("positive", "negative"):
        avg = stats[side]["average"]
        lo, med, hi = stats[side]["quartiles"]
        out[f"step/dense_per_sample_average_{side}_scores"] = nanmean(avg)
        out[f"step/dense_per_sample_lower_{side}_scores"] = nanmean(lo)
        out[f"step/dense_per_sample_median_{side}_scores"] = nanmean(med)
        out[f"step/dense_per_sample_upper_{side}_scores"] = nanmean(hi)
    out["train/+ive_scores_step"] = out["step/dense_per_sample_average_positive_scores"]
    out["train/-ive_scores_step"] = out["step/dense_per_sample_average_negative_scores"]
    return out
