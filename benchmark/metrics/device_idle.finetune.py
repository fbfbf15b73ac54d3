"""``device_idle.finetune``: % of the traced finetune window in which the device ran nothing."""

from bmk.readers import device_idle as read  # noqa: F401
