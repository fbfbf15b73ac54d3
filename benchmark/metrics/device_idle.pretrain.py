"""``device_idle.pretrain``: % of the traced pretrain window in which the device ran nothing."""

from bmk.readers import device_idle as read  # noqa: F401
