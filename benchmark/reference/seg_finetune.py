"""DeepLabV3 finetuning, three steps, in plain float32 PyTorch.

Per step: the augmentation; the segmentor's logits at the feature grid,
with dropout before the classifier; the logits resized linearly (half-pixel
centres) to the label's size; the mean pixel cross-entropy; the gradient;
Adam with L2 weight decay added to the gradient (PyTorch's ``Adam``, the
reference's optimizer).
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch
import torch.nn.functional as F

from reference import augment, nets

AUG_STREAM, DROPOUT_STREAM = 0, 1


def linear_resize_weights(in_size: int, out_size: int, device) -> torch.Tensor:
    """(out, in) weights of linear upsampling at half-pixel centres, the
    edge taps renormalised (the same as clamping the source index)."""
    pos = (torch.arange(out_size, device=device, dtype=torch.float32) + 0.5) \
        * (in_size / out_size) - 0.5
    src = torch.arange(in_size, device=device, dtype=torch.float32)
    w = torch.clamp(1.0 - (pos[:, None] - src[None, :]).abs(), min=0.0)
    return w / w.sum(dim=1, keepdim=True)


def loss_of(P, model: dict, images, masks, keep, keep_prob, prec: nets.Precision):
    logits = nets.segment_logits(P, model, images, keep, keep_prob, prec)
    logits = logits.permute(0, 2, 3, 1)
    wy = linear_resize_weights(logits.shape[1], masks.shape[1], logits.device).to(logits.dtype)
    wx = linear_resize_weights(logits.shape[2], masks.shape[2], logits.device).to(logits.dtype)
    logits = torch.einsum("oh,nhwc->nowc", wy, logits)
    logits = torch.einsum("pw,nowc->nopc", wx, logits)
    log_p = F.log_softmax(logits, dim=-1)
    return -log_p.gather(-1, masks.long()[..., None]).mean()


def run(P0: Dict[str, torch.Tensor], raw_of: Callable[[int], tuple], seed: int, model: dict,
        aug: dict, opt: dict, names: List[str], prec: nets.Precision = nets.FP32,
        steps: int = 3) -> dict:
    """``steps`` steps from ``P0``; ``raw_of(i)`` gives step i's uint8
    images and integer masks.  Returns each step's loss, the first step's
    gradient and the parameters after the last step."""
    P = {k: v.clone().requires_grad_(k in names) for k, v in P0.items()}
    m1 = {k: torch.zeros_like(P[k]) for k in names}
    m2 = {k: torch.zeros_like(P[k]) for k in names}
    b1, b2, eps = opt["betas"][0], opt["betas"][1], opt["eps"]
    keep_prob = 1.0 - model["decode_head"]["dropout_ratio"]
    ch = model["decode_head"]["channels"]
    losses, grad0 = [], None
    for i in range(steps):
        images, masks = raw_of(i)
        dev = images.device
        with torch.no_grad():
            images, masks = augment.finetune_augment(
                augment.step_generator(seed, i, dev, AUG_STREAM), images, masks, aug)
        n, h, w = masks.shape
        fh, fw = opt["feature_hw"]
        keep = torch.rand((n, ch, fh, fw), generator=augment.step_generator(
            seed, i, dev, DROPOUT_STREAM), device=dev) < keep_prob
        loss = loss_of(P, model, images, masks, keep, keep_prob, prec)
        grads = torch.autograd.grad(loss, [P[k] for k in names])
        losses.append(float(loss.detach()))
        if i == 0:
            grad0 = {k: g.detach().clone() for k, g in zip(names, grads)}
        t = i + 1
        with torch.no_grad():
            for k, g in zip(names, grads):
                d = g + opt["weight_decay"] * P[k]
                m1[k] = b1 * m1[k] + (1 - b1) * d
                m2[k] = b2 * m2[k] + (1 - b2) * d * d
                m_hat = m1[k] / (1 - b1 ** t)
                v_hat = m2[k] / (1 - b2 ** t)
                P[k] -= opt["lr"] * m_hat / (v_hat.sqrt() + eps)
        del loss, grads
    return {"loss": losses, "grad0": grad0,
            "params": {k: P[k].detach() for k in names}}
