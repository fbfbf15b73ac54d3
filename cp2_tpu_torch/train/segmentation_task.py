"""Supervised segmentation task: train state, train and eval steps, metrics.

Port of ``cp2_tpu/train/segmentation_task.py`` (the reference's Lightning
``SegmentationModule``, networks/segment_network.py:48-309): forward →
logits resized to label resolution → mean CE → confusion counts, Adam
(SGD for the iteration CLI).

* **Layout.**  ``seg_forward`` hands the segmentor a contiguous NCHW
  tensor, made explicitly from the NHWC batch, so cuDNN's choice of
  kernels never rests on the strides the batch happens to have (a
  channels-last input sends the dilated ASPP convs to a direct kernel
  several times slower).
* **Precision.**  The segmentor runs its convs in its dtype (bfloat16 in
  the CLI) with float32 BatchNorm; the logits are cast to float32 before
  the resize, and the prediction is the first maximum of the resized
  float32 logits, as ``jnp.argmax`` takes it.
* **Frozen parameters** (``--linear_evaluation``) get a zero gradient, as
  the JAX step zeroes their gradients before ``add_decayed_weights`` and
  Adam: the optimizer then still moves them by their decay term, as
  optax does (``ROADMAP.md`` §3, parity rules).
* **Randomness.**  The train step takes a ``torch.Generator`` on the
  state's device for the heads' dropout.
* **More than one process.**  Each rank steps on its rows of the global
  batch; BatchNorm reduces its statistics over the ranks and the dropout
  masks are drawn for the global batch (``parallel``), and the train step
  averages the gradients over the ranks (``pmean_gradients``).  The
  confusion counts and eval losses stay each rank's: the CLIs sum them
  over the ranks (``psum_metrics``) before ``compute_metrics``.

The steps update the state's model and optimizer in place and return the
new confusion counts; the JAX steps return new pytrees.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from cp2_tpu_torch.ops.losses import softmax_cross_entropy
from cp2_tpu_torch.ops.metrics import ConfusionState, compute_metrics
from cp2_tpu_torch.ops.resize import resize_bilinear
from cp2_tpu_torch.parallel import pmean_gradients
from cp2_tpu_torch.utils.profiling import span

BACKGROUND_CLASS = 0


@dataclass
class SegTrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_adam(learning_rate: float, weight_decay: float):
    """``params -> Adam``: optax ``chain(add_decayed_weights(wd), adam(lr))``
    is ``torch.optim.Adam(lr, weight_decay=wd)``: both add wd·p to the
    gradient before the moments (eps 1e-8, betas 0.9 / 0.999)."""
    return lambda params: torch.optim.Adam(params, lr=learning_rate,
                                           weight_decay=weight_decay)


def make_sgd(learning_rate: float, momentum: float = 0.9, weight_decay: float = 0.0):
    """``params -> SGD``: optax ``chain(add_decayed_weights(wd), sgd(lr,
    momentum))`` is ``torch.optim.SGD(lr, momentum, weight_decay=wd,
    dampening=0)``: wd·p joins the gradient before the momentum trace,
    and the first step's trace is the gradient itself."""
    return lambda params: torch.optim.SGD(params, lr=learning_rate, momentum=momentum,
                                          dampening=0.0, weight_decay=weight_decay)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set every parameter group's rate: an optax schedule read per step."""
    for group in optimizer.param_groups:
        group["lr"] = lr


def create_seg_state(model: torch.nn.Module, tx: Callable, device) -> SegTrainState:
    """The model on ``device`` in train mode, its optimizer ``tx(params)``,
    step 0."""
    model.to(device).train()
    return SegTrainState(model=model, optimizer=tx(model.parameters()), step=0)


def seg_forward(model: torch.nn.Module, images: torch.Tensor, image_hw: Tuple[int, int], *,
                with_aux: bool = False, generator: Optional[torch.Generator] = None):
    """Logits at label resolution (NHWC, float32) and the argmax prediction
    (reference segment_network.py:219-231); with ``with_aux`` the auxiliary
    head's resized logits too: ``(logits, aux_logits, preds)``.  Train or
    eval BatchNorm and dropout follow ``model.training``."""
    x = images.permute(0, 3, 1, 2).contiguous()
    out = model(x, with_aux=with_aux, generator=generator)
    aux_logits = None
    if with_aux:
        out, aux = out
        aux_logits = resize_bilinear(aux.float().permute(0, 2, 3, 1), image_hw)
    logits = resize_bilinear(out.float().permute(0, 2, 3, 1), image_hw)
    preds = torch.argmax(logits, dim=-1)
    if with_aux:
        return logits, aux_logits, preds
    return logits, preds


def build_decode_loss(decode_head_cfg: dict, *, ignore_index: int = 255):
    """The loss of ``decode_head.loss_decode`` (+ an OHEM ``sampler``), or
    ``None`` for the default mean CE (``segmentation_task.py:85-140``): the
    reference finetune computes its own CE, and keeping it keeps the loss
    equal for the reference configs.  OHEM's dropped pixels are remapped to
    ``ignore_index`` before the loss, which composes with every loss."""
    from cp2_tpu_torch.models.registry import LOSSES
    from cp2_tpu_torch.ops import seg_losses

    loss_cfg = dict(decode_head_cfg.get("loss_decode") or {})
    sampler_cfg = decode_head_cfg.get("sampler")
    default_ce = (loss_cfg.get("type", "CrossEntropyLoss") == "CrossEntropyLoss"
                  and not loss_cfg.get("use_sigmoid", False)
                  and float(loss_cfg.get("loss_weight", 1.0)) == 1.0)
    if default_ce and not sampler_cfg:
        return None
    loss_impl = LOSSES.get(loss_cfg.pop("type", "CrossEntropyLoss"))
    kwargs = dict(loss_cfg)
    kwargs.setdefault("ignore_index", ignore_index)
    ohem = None
    if sampler_cfg:
        if sampler_cfg.get("type") != "OHEMPixelSampler":
            raise NotImplementedError(f"sampler {sampler_cfg.get('type')!r}")
        ohem = dict(thresh=sampler_cfg.get("thresh"),
                    min_kept=int(sampler_cfg.get("min_kept", 100000)))

    def loss_fn(logits, labels):
        if ohem is not None:
            # batch_kept = min_kept * N (reference ohem_pixel_sampler.py:46)
            w = seg_losses.ohem_weights(logits, labels, thresh=ohem["thresh"],
                                        min_kept=ohem["min_kept"] * labels.shape[0],
                                        ignore_index=ignore_index)
            labels = torch.where(w > 0, labels, ignore_index)
        return loss_impl(logits, labels, **kwargs)

    return loss_fn


def make_seg_steps(num_classes: int, image_hw: Tuple[int, int], *,
                   frozen: Optional[Callable[[str], bool]] = None,
                   aux_loss_weight: float = 0.4, loss_fn: Optional[Callable] = None):
    """Build ``(train_step, eval_step, metrics_of)``.

    * ``train_step(state, batch, generator, confusion) -> (state, confusion,
      {"loss"})``: batch ``image`` (N, H, W, 3) float32 and ``mask``
      (N, H, W); ``generator`` draws the dropout masks.
    * ``eval_step(state, batch, confusion) -> (confusion, {"loss",
      "weight"})``, eval mode, no gradient; the batch's ``valid`` (N,) bool
      drops padded rows from the loss and the counts.
    * ``metrics_of(confusion, prefix)``: the reference's metric keys.

    ``frozen(name)`` marks parameters (by ``named_parameters`` name) whose
    gradient is zeroed (``--linear_evaluation``).  With an auxiliary head,
    its CE is added at ``aux_loss_weight`` in training.  ``loss_fn``
    (``build_decode_loss``) replaces the default mean CE.
    """
    binary = num_classes == 2
    ignore = None if binary else BACKGROUND_CLASS
    base_loss = loss_fn if loss_fn is not None else softmax_cross_entropy

    def train_step(state: SegTrainState, batch, generator, confusion: ConfusionState):
        with span("finetune.step"):
            model = state.model
            model.train()
            images, masks = batch["image"], batch["mask"]
            has_aux = getattr(model, "auxiliary_head", None) is not None
            with span("finetune.forward"):
                if has_aux:
                    logits, aux_logits, preds = seg_forward(model, images, image_hw, with_aux=True,
                                                            generator=generator)
                    loss = (base_loss(logits, masks)
                            + aux_loss_weight * softmax_cross_entropy(aux_logits, masks))
                else:
                    logits, preds = seg_forward(model, images, image_hw, generator=generator)
                    loss = base_loss(logits, masks)
            with span("finetune.backward"):
                state.optimizer.zero_grad(set_to_none=True)
                loss.backward()
            with span("finetune.grad_reduce"):
                for name, p in model.named_parameters():
                    # a zero gradient, not None: torch's optimizers skip a parameter
                    # without one, where optax still decays it
                    if p.grad is None or (frozen is not None and frozen(name)):
                        p.grad = torch.zeros_like(p)
                pmean_gradients(model.parameters())
            with span("finetune.optimizer"):
                state.optimizer.step()
            state.step += 1
            with span("finetune.confusion"):
                confusion = confusion.update(preds, masks)
            return state, confusion, {"loss": loss.detach()}

    @torch.no_grad()
    def eval_step(state: SegTrainState, batch, confusion: ConfusionState):
        model = state.model
        was_training = model.training
        model.eval()
        images, masks = batch["image"], batch["mask"]
        row_mask = batch.get("valid")
        logits, preds = seg_forward(model, images, image_hw)
        if loss_fn is None:
            loss = softmax_cross_entropy(logits, masks, sample_mask=row_mask)
        else:
            # custom losses take no row mask: the pad rows become ignore_index
            masks_for_loss = masks
            if row_mask is not None:
                masks_for_loss = torch.where(
                    row_mask.reshape((-1,) + (1,) * (masks.dim() - 1)), masks, 255)
            loss = loss_fn(logits, masks_for_loss)
        weight = (torch.tensor(float(images.shape[0]), device=images.device) if row_mask is None
                  else row_mask.sum().to(torch.float32))
        model.train(was_training)
        return (confusion.update(preds, masks, sample_mask=row_mask),
                {"loss": loss, "weight": weight})

    def metrics_of(confusion: ConfusionState, prefix: str) -> Dict[str, torch.Tensor]:
        return compute_metrics(confusion, binary=binary, ignore_index=ignore, prefix=prefix)

    return train_step, eval_step, metrics_of
