"""``dispatch_ms.finetune_files``: Host ms per step of the files-fed finetune inside the program's step and augmentation spans, less its host syncs there."""

from bmk.program import dispatch_ms as read  # noqa: F401
