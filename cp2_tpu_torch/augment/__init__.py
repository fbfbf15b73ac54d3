"""On-device augmentation of the CP2 pretrain path (batched, on tensors)."""

from cp2_tpu_torch.augment.pipeline import (
    AugmentConfig,
    PretrainAugParams,
    apply_pretrain_augment,
    background_augment_batch,
    pretrain_batch_augment,
    sample_pretrain_params,
    two_crop_augment_batch,
)

__all__ = [
    "AugmentConfig",
    "PretrainAugParams",
    "apply_pretrain_augment",
    "background_augment_batch",
    "pretrain_batch_augment",
    "sample_pretrain_params",
    "two_crop_augment_batch",
]
