"""``kernels_per_step.pretrain``: Kernels one pretrain step launches (the median over the window's steps)."""

from bmk.program import kernels_per_step as read  # noqa: F401
