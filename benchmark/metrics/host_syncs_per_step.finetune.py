"""``host_syncs_per_step.finetune``: Host sync calls one finetune step makes (the median over the window's steps)."""

from bmk.program import host_syncs_per_step as read  # noqa: F401
