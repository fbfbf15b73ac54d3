"""``kernels_per_step.finetune``: Kernels one finetune step launches (the median over the window's steps)."""

from bmk.program import kernels_per_step as read  # noqa: F401
