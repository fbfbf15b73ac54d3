"""``device_idle.finetune_files``: % of the traced window of the files-fed finetune in which the device ran nothing."""

from bmk.readers import device_idle as read  # noqa: F401
