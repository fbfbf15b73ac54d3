"""On-device augmentation of the pretrain and finetune paths (batched, on tensors)."""

from cp2_tpu_torch.augment.pipeline import (
    AugmentConfig,
    FinetuneAugmentConfig,
    PretrainAugParams,
    apply_eval_augment,
    apply_finetune_augment,
    apply_pretrain_augment,
    background_augment_batch,
    eval_augment_batch,
    finetune_augment_batch,
    lemon_augment_config,
    pretrain_batch_augment,
    sample_eval_params,
    sample_finetune_params,
    sample_pretrain_params,
    two_crop_augment_batch,
)

__all__ = [
    "AugmentConfig",
    "FinetuneAugmentConfig",
    "PretrainAugParams",
    "apply_eval_augment",
    "apply_finetune_augment",
    "apply_pretrain_augment",
    "background_augment_batch",
    "eval_augment_batch",
    "finetune_augment_batch",
    "lemon_augment_config",
    "pretrain_batch_augment",
    "sample_eval_params",
    "sample_finetune_params",
    "sample_pretrain_params",
    "two_crop_augment_batch",
]
