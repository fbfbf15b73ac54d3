"""CutPaste/"mirror" pretext task steps.

Port of ``cp2_tpu/train/mirror_task.py`` (the reference's ``MirrorModule``,
networks/mirror_network.py:8-86): per batch, forward the image and its
"mirror" (the same pasted patch on another base image), supervise both
with the patch mask (CE), and add a temperature-softened consistency loss
between the two predictions.

* **The consistency loss** is ported literally: the reference passes
  *probabilities* into ``nn.CrossEntropyLoss``, which log-softmaxes its
  input again, so the loss is ``-Σ softmax(t/T) · log_softmax(softmax(s/T))``.
* **One dropout draw for both forwards.**  The JAX step hands both train
  forwards the same dropout key, so image and mirror get the same dropout
  mask: the generator's state is taken before the first forward and set
  back before the second.
* **BatchNorm.**  The second forward normalises with its own batch and
  updates the running statistics that the first forward already updated,
  as the JAX step threads the first forward's ``batch_stats`` into the
  second.
* Parameters the loss never reaches get a zero gradient, so Adam's decay
  still moves them, as optax's does (``segmentation_task.py``).

The steps update the state's model and optimizer in place and return the
new confusion counts, as ``make_seg_steps`` does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from cp2_tpu_torch.ops.losses import softmax_cross_entropy
from cp2_tpu_torch.ops.metrics import ConfusionState
from cp2_tpu_torch.parallel import pmean_gradients
from cp2_tpu_torch.train.segmentation_task import SegTrainState, seg_forward
from cp2_tpu_torch.types import MirrorVariant


def mirror_consistency_loss(s_logits: torch.Tensor, t_logits: torch.Tensor,
                            temperature: float,
                            sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``mirror_task.py:29-41``; ``sample_mask`` (N,) bool drops padded rows."""
    s_probs = F.softmax(s_logits / temperature, dim=-1)
    t_probs = F.softmax(t_logits / temperature, dim=-1)
    log_q = F.log_softmax(s_probs, dim=-1)  # literal reference behaviour
    ce = -(t_probs * log_q).sum(dim=-1)
    if sample_mask is None:
        return ce.mean()
    w = sample_mask.reshape((-1,) + (1,) * (ce.dim() - 1)).to(ce.dtype)
    return (ce * w).sum() / (w.sum() * (ce.numel() // ce.shape[0])).clamp_min(1)


def make_mirror_steps(num_classes: int, image_hw: Tuple[int, int], *,
                      mirror_variant: MirrorVariant = MirrorVariant.OUTPUT,
                      lmbd_compare_loss: float = 0.01, softmax_temp: float = 2.0):
    """Build ``(train_step, eval_step)`` (``mirror_task.py:44-143``).

    * ``train_step(state, batch, generator, confusion) -> (state, confusion,
      {"train_loss", "train_class_loss", "train_compare_loss"})``: batch
      ``image`` (and ``mirror`` for OUTPUT) (N, H, W, 3) float32, ``mask``
      (N, H, W); ``generator`` draws the dropout masks.
    * ``eval_step(state, batch, confusion) -> (confusion, {"val_loss",
      "weight"})``, eval mode, no gradient; the batch's ``valid`` (N,) bool
      drops padded rows from the losses and the counts, and ``weight`` is
      the count of real rows.
    """
    del num_classes  # the confusion state carries it, as in the JAX step
    with_mirror = mirror_variant == MirrorVariant.OUTPUT

    def train_step(state: SegTrainState, batch, generator: torch.Generator,
                   confusion: ConfusionState):
        model = state.model
        model.train()
        if with_mirror:
            rng_state = generator.get_state()
            s_logits, _ = seg_forward(model, batch["image"], image_hw, generator=generator)
            generator.set_state(rng_state)  # the same dropout key for both forwards
            t_logits, _ = seg_forward(model, batch["mirror"], image_hw, generator=generator)
            all_logits = torch.cat([s_logits, t_logits])
            all_masks = torch.cat([batch["mask"], batch["mask"]])
            compare = mirror_consistency_loss(s_logits, t_logits, softmax_temp)
        else:
            all_logits, _ = seg_forward(model, batch["image"], image_hw, generator=generator)
            all_masks = batch["mask"]
            compare = torch.zeros((), device=all_logits.device)
        class_loss = softmax_cross_entropy(all_logits, all_masks)
        loss = class_loss + lmbd_compare_loss * compare
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for p in model.parameters():
            # a zero gradient, not None: torch's optimizers skip a parameter
            # without one, where optax still decays it
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        pmean_gradients(model.parameters())  # over the ranks, as the segmentation step
        state.optimizer.step()
        state.step += 1
        preds = torch.argmax(all_logits.detach(), dim=-1)
        metrics = {"train_loss": loss.detach(), "train_class_loss": class_loss.detach(),
                   "train_compare_loss": compare.detach()}
        return state, confusion.update(preds, all_masks), metrics

    @torch.no_grad()
    def eval_step(state: SegTrainState, batch, confusion: ConfusionState):
        model = state.model
        was_training = model.training
        model.eval()
        row_mask = batch.get("valid")
        if with_mirror:
            s_logits, _ = seg_forward(model, batch["image"], image_hw)
            t_logits, _ = seg_forward(model, batch["mirror"], image_hw)
            all_logits = torch.cat([s_logits, t_logits])
            all_masks = torch.cat([batch["mask"], batch["mask"]])
            all_row_mask = None if row_mask is None else torch.cat([row_mask, row_mask])
            compare = mirror_consistency_loss(s_logits, t_logits, softmax_temp,
                                              sample_mask=row_mask)
        else:
            all_logits, _ = seg_forward(model, batch["image"], image_hw)
            all_masks = batch["mask"]
            all_row_mask = row_mask
            compare = 0.0
        class_loss = softmax_cross_entropy(all_logits, all_masks, sample_mask=all_row_mask)
        loss = class_loss + lmbd_compare_loss * compare
        preds = torch.argmax(all_logits, dim=-1)
        n = batch["image"].shape[0]
        weight = (torch.tensor(float(n), device=preds.device) if row_mask is None
                  else row_mask.sum().to(torch.float32))
        model.train(was_training)
        return (confusion.update(preds, all_masks, sample_mask=all_row_mask),
                {"val_loss": loss, "weight": weight})

    return train_step, eval_step
