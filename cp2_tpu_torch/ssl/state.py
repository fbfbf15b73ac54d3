"""Pretrain train-state: query encoder, EMA key encoder, optimizer, queues.

Port of ``cp2_tpu/ssl/state.py``.  The flax state holds one module
definition and two parameter trees; here it holds two modules — the query
``model`` and the EMA key ``ema_model`` — each with its own BatchNorm
buffers, and the step updates them in place.

EMA semantics: the momentum update touches *parameters only* — BN running
statistics are NOT averaged (the reference iterates ``.parameters()``,
builder.py:557-567); the key encoder's stats evolve through its own
forwards.  Both queues always exist, as in the JAX state: ``queue`` holds
instance-level negatives (CP2, PROPOSED, MoCo, DenseCL's global loss) and
``queue2`` DenseCL's pooled local ones.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable

import torch

from cp2_tpu_torch.ssl.hparams import SSLHyperParams
from cp2_tpu_torch.ssl.model import SSLEncoder
from cp2_tpu_torch.ssl.queue import init_queue


@dataclass
class PretrainState:
    step: int
    model: SSLEncoder
    ema_model: SSLEncoder
    optimizer: torch.optim.Optimizer
    queue: torch.Tensor  # (K, dim) instance-level negatives
    queue_ptr: int
    queue2: torch.Tensor  # (K, dim) dense/pooled negatives (DenseCL family)
    queue2_ptr: int

    @torch.no_grad()
    def ema_update(self, momentum: float) -> None:
        """k ← k·m + q·(1−m) over the parameters (builder.py:557-567)."""
        ema = list(self.ema_model.parameters())
        torch._foreach_mul_(ema, momentum)
        torch._foreach_add_(ema, list(self.model.parameters()), alpha=1.0 - momentum)


def create_pretrain_state(
    model: SSLEncoder,
    tx: Callable,
    hp: SSLHyperParams,
    *,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> PretrainState:
    """Random weights from ``seed``, key encoder = exact copy of the query
    encoder (builder.py:464-469), two random unit queues, and the optimizer
    ``tx(params)`` (see ``train_step.make_optimizer``)."""
    gen = torch.Generator().manual_seed(seed)
    model.init_weights(gen)
    queue = init_queue(gen, hp.queue_len, hp.dim)
    queue2 = init_queue(gen, hp.queue_len, hp.dim)
    model.to(device).train()
    ema_model = copy.deepcopy(model)
    ema_model.requires_grad_(False)
    return PretrainState(
        step=0,
        model=model,
        ema_model=ema_model,
        optimizer=tx(model.parameters()),
        queue=queue.to(device),
        queue_ptr=0,
        queue2=queue2.to(device),
        queue2_ptr=0,
    )
