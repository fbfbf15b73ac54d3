"""``loader_wait_ms.finetune``: Host ms per finetune step blocked on the next staged batch (files cells)."""

from bmk.readers import loader_wait_ms as read  # noqa: F401
