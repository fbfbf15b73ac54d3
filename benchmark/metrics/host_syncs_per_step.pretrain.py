"""``host_syncs_per_step.pretrain``: Host sync calls one pretrain step makes (the median over the window's steps)."""

from bmk.program import host_syncs_per_step as read  # noqa: F401
