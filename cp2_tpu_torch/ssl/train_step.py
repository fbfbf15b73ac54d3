"""The pretrain step: EMA, key forward, query forward/backward, SGD, enqueue.

Port of the CP2 branch of ``cp2_tpu/ssl/train_step.py``.  The JAX step is
one pure jitted ``state -> state`` transition; here the step runs eagerly
and updates the state's modules, optimizer and queue in place, in the
same order: EMA update BEFORE the key forward (builder.py:726,1272), key
forward in train mode without grad, query forward and backward, optimizer
update, enqueue.  The MoCo/BYOL/DenseCL branches are not ported yet.

Per-step randomness: the JAX step folds the step counter into one base
key (``jax.random.fold_in(rng, state.step)``); here each step seeds a
fresh generator on the state's device from (base seed, ``state.step``)
(``step_generator``), so a resumed run replays the same draws.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch

from cp2_tpu_torch.ssl import objectives as obj
from cp2_tpu_torch.ssl.hparams import SSLHyperParams
from cp2_tpu_torch.ssl.queue import queue_enqueue
from cp2_tpu_torch.ssl.state import PretrainState
from cp2_tpu_torch.types import BackboneType, PretrainType


def backbone_output_stride_of(model_cfg: dict, backbone_type: BackboneType,
                              unet_truncated_dec_blocks: int = 2) -> int:
    if backbone_type == BackboneType.UNET_ENCODER_ONLY:
        return 32
    if backbone_type == BackboneType.UNET_TRUNCATED:
        return 32 >> unet_truncated_dec_blocks
    strides = model_cfg["backbone"].get("strides", (1, 2, 2, 2))
    return 4 * int(math.prod(strides))


def dense_output_stride_of(model_cfg: dict, backbone_type: BackboneType,
                           unet_truncated_dec_blocks: int = 2) -> int:
    """Output stride of the SSLEncoder 'dense' path for any backbone type."""
    if backbone_type == BackboneType.DEEPLABV3:
        strides = model_cfg["backbone"].get("strides", (1, 2, 2, 2))
        return 4 * int(math.prod(strides))
    return backbone_output_stride_of(model_cfg, backbone_type,
                                     unet_truncated_dec_blocks)


# the CP2 epoch-aggregate family, (epoch name, step source), in the order
# of the JAX package's epoch_scalar_names(PretrainType.CP2)
# (builder.py:1608-1664)
CP2_EPOCH_SCALARS = (
    ("train/loss", "train/loss_step"),
    ("train/acc_ins", "train/acc_ins_step"),
    ("train/loss_ins", "train/loss_ins_step"),
    ("train/loss_dense", "train/loss_dense_step"),
    ("train/cross_image_variance_source", "train/cross_image_variance_source_step"),
    ("train/cross_image_variance_target", "train/cross_image_variance_target_step"),
    ("train/acc_seg", "train/acc_seg_step"),
)


def epoch_scalar_names(pt: PretrainType) -> Tuple[str, ...]:
    """The scalars the reference averages over every step into its epoch
    aggregates (builder.py:1608-1664); CP2 only in the port so far."""
    if pt != PretrainType.CP2:
        raise NotImplementedError(f"pretrain_type={pt} is not ported yet")
    return tuple(name for name, _ in CP2_EPOCH_SCALARS)


_SEED_MIX = 0x9E3779B97F4A7C15  # odd 64-bit constant: (seed, step) -> one seed


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from (base seed, step): every step
    draws from its own stream, and the same step draws the same values."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * _SEED_MIX + int(step)) % (1 << 63))
    return gen


def make_pretrain_step(
    hp: SSLHyperParams,
    output_stride: int,
    *,
    metrics_level: int = 0,
    epoch_scalars: bool = False,
    augment_fn: Callable | None = None,
) -> Callable[[PretrainState, Dict[str, torch.Tensor]],
              Tuple[PretrainState, Dict[str, torch.Tensor]]]:
    """Build ``step_fn(state, batch, seed=0) -> (state, metrics)`` for CP2.

    Differs from the JAX signature in what PyTorch makes unnecessary: the
    model and optimizer live in the state, and the base PRNG key is an
    integer ``seed``.  ``augment_fn(generator, raw) -> batch`` turns raw
    frames into the CP2 batch on the step's device, drawing from
    ``step_generator(seed, state.step, device)``; without it the batch comes
    pre-augmented, NHWC.  ``metrics_level`` 1 adds the reference's scalar
    families, 2 the ``_visual/*`` arrays.  ``epoch_scalars`` adds
    ``metrics["_epoch_vec"]`` in ``CP2_EPOCH_SCALARS`` order.
    """
    if hp.pretrain_type != PretrainType.CP2:
        raise NotImplementedError(f"pretrain_type={hp.pretrain_type} is not ported yet")

    def step_fn(state: PretrainState, batch, seed: int = 0):
        if augment_fn is not None:
            device = state.queue.device
            batch = augment_fn(step_generator(seed, state.step, device), batch)
        state.ema_update(hp.momentum)
        key_out = obj.cp2_key_forward(state.ema_model, batch)
        loss, aux = obj.cp2_objective(
            state.model, key_out, batch, state.queue, hp, output_stride,
            metrics_level=metrics_level, epoch_scalars=epoch_scalars,
        )
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.queue_ptr = queue_enqueue(state.queue, state.queue_ptr,
                                        aux["enqueue"]["queue"])
        state.step += 1
        metrics = dict(aux["metrics"])
        metrics["loss"] = loss.detach()
        if epoch_scalars:
            metrics["_epoch_vec"] = torch.stack(
                [metrics[src].float() for _, src in CP2_EPOCH_SCALARS])
        return state, metrics

    return step_fn


def cosine_lr_schedule(base_lr: float, epochs: int, steps_per_epoch: int):
    """Per-epoch cosine decay (reference adjust_learning_rate, main.py:693-698)."""

    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * epoch / epochs))

    return schedule


def make_optimizer(optim: str, lr: float, *, momentum: float = 0.9,
                   weight_decay: float = 1e-4):
    """``params -> torch.optim.Optimizer``, the reference's two options
    (main.py:467-477).

    optax ``add_decayed_weights(wd)`` then ``sgd(lr, momentum)`` is
    ``torch.optim.SGD(lr, momentum, weight_decay=wd)``: both add wd·p to
    the gradient before the momentum trace, which starts at the first
    gradient.  ``adamw`` matches ``optax.adamw(lr, weight_decay=0.01)``.
    """
    if optim == "sgd":
        return lambda params: torch.optim.SGD(params, lr=lr, momentum=momentum,
                                              weight_decay=weight_decay)
    if optim == "adamw":
        return lambda params: torch.optim.AdamW(params, lr=lr, weight_decay=0.01)
    raise NotImplementedError("Only sgd and adamw optimizers are supported.")
