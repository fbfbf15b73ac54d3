"""CP2 pretraining, three steps, in plain float32 PyTorch.

Per step, in the order of CP2's reference implementation: draw and apply
the augmentation; move the key encoder's parameters toward the query
encoder's (EMA, before the key forward); the key encoder's dense
embedding of the composited second view (train-mode BatchNorm, no
gradient); the query's; the CP2 objective: InfoNCE of the masked-mean
embeddings against the in-batch key and the queue, plus the dense pair
loss (softmax over the query pixels, every foreground pair positive)
formed with ``einsum``; the gradient; SGD with momentum and weight decay;
the keys enqueued.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch
import torch.nn.functional as F

from reference import augment, nets


def composite(img: torch.Tensor, bg: torch.Tensor):
    """Copy-paste: the image shows where the background was erased to 0."""
    mask = (bg[..., 0] == 0).to(img.dtype)
    return img * mask[..., None] + bg, mask


def objective(P, E, batch, queue, hp: dict, model: dict, prec: nets.Precision):
    """(loss, keys to enqueue)."""
    stride = hp["output_stride"]
    img_a, mask_a = composite(batch["img_a"], batch["bg0"])
    img_b, mask_b = composite(batch["img_b"], batch["bg1"])
    n = img_a.shape[0]
    ma = mask_a[:, stride // 2::stride, stride // 2::stride].reshape(n, -1)
    mb = mask_b[:, stride // 2::stride, stride // 2::stride].reshape(n, -1)
    with torch.no_grad():
        k_out = nets.contrast_embed(E, model, img_b, prec=prec)
    q_out = nets.contrast_embed(P, model, img_a, prec=prec)
    s2 = q_out.shape[1] * q_out.shape[2]
    q = nets.l2_normalize(q_out.reshape(n, s2, -1))
    k = nets.l2_normalize(k_out.reshape(n, s2, -1))
    ma, mb = ma.to(q.dtype), mb.to(q.dtype)
    q_pos = nets.l2_normalize(torch.einsum("nxc,nx->nc", q, ma))
    k_pos = nets.l2_normalize(torch.einsum("nxc,nx->nc", k, mb))
    logits = torch.einsum("nxc,nyc->nxy", q, k) / hp["dense_logits_temp"]
    labels = ma[:, :, None] * mb[:, None, :]
    log_sm = F.log_softmax(logits, dim=1)
    dense = ((-log_sm * labels).reshape(n, -1).sum(1)
             / labels.reshape(n, -1).sum(1).clamp_min(1e-12)).mean()
    l_pos = torch.einsum("nc,nc->n", q_pos, k_pos)[:, None]
    l_neg = q_pos @ queue.to(q_pos.dtype).T
    inst = -F.log_softmax(torch.cat([l_pos, l_neg], 1) / hp["instance_logits_temp"],
                          dim=1)[:, 0].mean()
    return inst + hp["lmbd_cp2_dense_loss"] * dense, k_pos.detach()


def run(P0: Dict[str, torch.Tensor], queue0: torch.Tensor, raw_of: Callable[[int], dict],
        seed: int, lrs: List[float], model: dict, hp: dict, aug: dict, opt: dict,
        names: List[str], prec: nets.Precision = nets.FP32, steps: int = 3) -> dict:
    """``steps`` steps from the weights ``P0`` and queue ``queue0``;
    ``raw_of(i)`` gives step i's uint8 frames.  Returns each step's loss,
    the first step's gradient, and the query and key encoders' parameters
    after the last step."""
    P = {k: v.clone().requires_grad_(k in names) for k, v in P0.items()}
    E = {k: v.clone() for k, v in P0.items()}
    queue, ptr = queue0.clone(), 0
    buf: Dict[str, torch.Tensor] = {}
    losses, grad0 = [], None
    m = hp["momentum"]
    for i in range(steps):
        with torch.no_grad():
            batch = augment.pretrain_augment(
                augment.step_generator(seed, i, queue.device), raw_of(i), aug)
            for k in names:
                E[k] = E[k] * m + P[k] * (1.0 - m)
        loss, keys = objective(P, E, batch, queue, hp, model, prec)
        grads = torch.autograd.grad(loss, [P[k] for k in names])
        losses.append(float(loss.detach()))
        if i == 0:
            grad0 = {k: g.detach().clone() for k, g in zip(names, grads)}
        with torch.no_grad():
            for k, g in zip(names, grads):
                d = g + opt["weight_decay"] * P[k]
                buf[k] = d if i == 0 else opt["momentum"] * buf[k] + d
                P[k] -= lrs[i] * buf[k]
            idx = (torch.arange(keys.shape[0], device=queue.device) + ptr) % queue.shape[0]
            queue[idx] = keys.to(queue.dtype)
            ptr = (ptr + keys.shape[0]) % queue.shape[0]
        del batch, loss, grads
    return {"loss": losses, "grad0": grad0,
            "params": {k: P[k].detach() for k in names}, "ema": {k: E[k] for k in names}}
