"""``mfu.finetune``: The finetune steps' FLOPs (the benchmark's own count) per second, % of the bf16 peak."""

from bmk.readers import mfu as read  # noqa: F401
