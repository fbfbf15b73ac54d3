"""The pretrain step: EMA, key forward, query forward/backward, SGD, enqueue.

Port of ``cp2_tpu/ssl/train_step.py``, every branch: CP2/PROPOSED,
MoCo-v2, BYOL, DenseCL/PROPOSED_V2.  The JAX step is one pure jitted
``state -> state`` transition; here the step runs eagerly and updates the
state's modules, optimizer and queues in place, in the same order: EMA
update BEFORE the key forward (builder.py:726,1272), key forward in train
mode without grad, query forward and backward, optimizer update, enqueue.

Per-step randomness: the JAX step folds the step counter into one base
key (``jax.random.fold_in(rng, state.step)``); here each step seeds a
fresh generator on the state's device from (base seed, ``state.step``)
(``step_generator``), so a resumed run replays the same draws.

More than one process (``parallel``): each rank steps on its rows of the
global batch, and what global-view ``jit`` does implicitly is explicit.
BatchNorm reduces its statistics over the ranks (``models/layers.py``);
after the backward ``pmean_gradients`` averages the gradients (explicit
all-reduces rather than ``DistributedDataParallel``, which would need
``find_unused_parameters`` for the zero-gradient rule below and would
change the one-process path); every rank enqueues the global batch's keys
(``concat_all_gather``), so every queue and pointer equals the one-process
run's; and a metrics step reports the mean over the ranks of each scalar
(``psum / W``).  The quiet step's ``_epoch_vec`` stays this rank's: the
CLI sums it over the ranks at the end of the epoch.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch

from cp2_tpu_torch.parallel import concat_all_gather, pmean_gradients, pmean_metrics
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


# Per-variant epoch-aggregate families (reference on_train_epoch_end,
# builder.py:1608-1664): epoch name -> candidate step-metric sources
# (``cp2_tpu/ssl/train_step.py:51-84``).
EPOCH_SOURCES = {
    "train/loss": ("train/loss_step",),
    "train/acc_ins": ("train/acc_ins_step",),
    "train/loss_ins": ("train/loss_ins_step",),
    "train/loss_dense": ("train/loss_dense_step",),
    "train/acc_seg": ("train/acc_seg_step",),
    "train/cross_image_variance_source": (
        "train/cross_image_variance_source_step",
        "step/cross_image_variance_source_step",
    ),
    "train/cross_image_variance_target": (
        "train/cross_image_variance_target_step",
        "step/cross_image_variance_target_step",
    ),
}


def epoch_scalar_names(pt: PretrainType) -> Tuple[str, ...]:
    """The scalars the reference averages over every step into its epoch
    aggregates, per variant (builder.py:1608-1664)."""
    names = ["train/loss"]
    if pt in (PretrainType.MOCO, PretrainType.CP2, PretrainType.PROPOSED):
        names.append("train/acc_ins")
    if pt in (PretrainType.DENSECL, PretrainType.PROPOSED_V2, PretrainType.CP2):
        names += ["train/loss_ins", "train/loss_dense"]
    if pt in (PretrainType.PROPOSED_V2, PretrainType.CP2):
        names += ["train/cross_image_variance_source",
                  "train/cross_image_variance_target"]
    if pt == PretrainType.CP2:
        names.append("train/acc_seg")
    return tuple(names)


def epoch_vector(pt: PretrainType, metrics: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The variant's epoch family packed in ``epoch_scalar_names`` order."""
    vec = []
    for name in epoch_scalar_names(pt):
        src = next((s for s in EPOCH_SOURCES[name] if s in metrics), None)
        if src is None:
            raise KeyError(f"epoch scalar {name} has no source in step metrics")
        vec.append(metrics[src].float())
    return torch.stack(vec)


_SEED_MIX = 0x9E3779B97F4A7C15  # odd 64-bit constant: (seed, step) -> one seed
_STREAM_MIX = 0xD1B54A32D192ED03  # another, to keep the streams of one step apart


def step_generator(seed: int, step: int, device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` seeded from (base seed, step, stream): every
    step draws from its own stream, and the same step draws the same values.
    ``stream`` separates the draws of one step that must not share values
    (the finetune step's augmentation and dropout)."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * _SEED_MIX + int(step) + int(stream) * _STREAM_MIX)
                    % (1 << 63))
    return gen


def make_pretrain_step(
    hp: SSLHyperParams,
    output_stride: int,
    backbone_output_stride: int | None = None,
    *,
    metrics_level: int = 0,
    epoch_scalars: bool = False,
    augment_fn: Callable | None = None,
) -> Callable[[PretrainState, Dict[str, torch.Tensor]],
              Tuple[PretrainState, Dict[str, torch.Tensor]]]:
    """Build ``step_fn(state, batch, seed=0) -> (state, metrics)`` for the
    variant ``hp.pretrain_type``.

    Differs from the JAX signature in what PyTorch makes unnecessary: the
    model and optimizer live in the state, and the base PRNG key is an
    integer ``seed``.  ``backbone_output_stride`` subsamples the pixel ids
    of DenseCL/PROPOSED_V2 (required there).  ``augment_fn(generator, raw)
    -> batch`` turns raw frames into the batch on the step's device,
    drawing from ``step_generator(seed, state.step, device)``; without it
    the batch comes pre-augmented, NHWC.  ``metrics_level`` 1 adds the
    reference's scalar families, 2 the ``_visual/*`` arrays.
    ``epoch_scalars`` adds ``metrics["_epoch_vec"]`` in
    ``epoch_scalar_names`` order.

    Parameters the loss does not reach (MoCo's predictor, the segmentor's
    unused ``conv_seg``, DenseCL's predictors without ``use_predictor``)
    get a zero gradient: ``jax.value_and_grad`` gives them zeros, and the
    JAX optimizer's weight decay and momentum still move them, where
    ``torch.optim`` would skip a parameter without a gradient.
    """
    pt = hp.pretrain_type
    dense_family = pt in (PretrainType.DENSECL, PretrainType.PROPOSED_V2)
    if pt not in (PretrainType.CP2, PretrainType.PROPOSED, PretrainType.MOCO,
                  PretrainType.BYOL) and not dense_family:
        raise NotImplementedError(f"pretrain_type={pt}")
    if dense_family and backbone_output_stride is None:
        raise ValueError(f"{pt.name} needs backbone_output_stride")
    kw = dict(metrics_level=metrics_level, epoch_scalars=epoch_scalars)

    def step_fn(state: PretrainState, batch, seed: int = 0):
        if augment_fn is not None:
            device = state.queue.device
            batch = augment_fn(step_generator(seed, state.step, device), batch)
        # momentum update BEFORE the key forward (builder.py:726,1272)
        state.ema_update(hp.momentum)
        if pt in (PretrainType.CP2, PretrainType.PROPOSED):
            key_out = obj.cp2_key_forward(state.ema_model, batch)
            loss, aux = obj.cp2_objective(state.model, key_out, batch, state.queue, hp,
                                          output_stride, **kw)
        elif pt == PretrainType.MOCO:
            key_out = obj.moco_key_forward(state.ema_model, batch)
            loss, aux = obj.moco_objective(state.model, key_out, batch, state.queue, hp,
                                           **kw)
        elif pt == PretrainType.BYOL:
            key_out = obj.byol_key_forward(state.ema_model, batch)
            loss, aux = obj.byol_objective(state.model, key_out, batch, hp, **kw)
        else:
            # the reference's momentum update lives inside get_key_features
            # (builder.py:723-726): the symmetric loss applies the EMA twice
            # a step, and direction 2's keys (img_a) come from the
            # twice-updated encoder, its BatchNorm chained from direction 1
            key_out = [obj.densecl_key_forward(state.ema_model, batch["img_b"])]
            if hp.use_symmetrical_loss:
                state.ema_update(hp.momentum)
                key_out.append(obj.densecl_key_forward(state.ema_model, batch["img_a"]))
            loss, aux = obj.densecl_objective(
                state.model, key_out, batch, (state.queue, state.queue2), hp,
                backbone_output_stride, state.step, **kw)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for p in state.model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        pmean_gradients(state.model.parameters())
        state.optimizer.step()
        enq = aux["enqueue"]
        if "queue" in enq:
            state.queue_ptr = queue_enqueue(state.queue, state.queue_ptr,
                                            concat_all_gather(enq["queue"]))
        if "queue2" in enq:
            state.queue2_ptr = queue_enqueue(state.queue2, state.queue2_ptr,
                                             concat_all_gather(enq["queue2"]))
        state.step += 1
        metrics = dict(aux["metrics"])
        metrics["loss"] = loss.detach()
        if epoch_scalars:
            metrics["_epoch_vec"] = epoch_vector(pt, metrics)
        if metrics_level >= 1:
            metrics.update(pmean_metrics(
                {k: v for k, v in metrics.items() if not k.startswith("_")}))
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
