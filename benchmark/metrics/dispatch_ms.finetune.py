"""``dispatch_ms.finetune``: Host ms per finetune step inside the program's step and augmentation spans, less its host syncs there."""

from bmk.program import dispatch_ms as read  # noqa: F401
