"""``dispatch_ms.pretrain``: Host ms per pretrain step inside the program's step spans, less its host syncs there."""

from bmk.program import dispatch_ms as read  # noqa: F401
