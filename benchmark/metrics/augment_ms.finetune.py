"""``augment_ms.finetune``: Device ms per finetune step of the kernels launched inside the augmentation span."""

from bmk.readers import augment_ms as read  # noqa: F401
