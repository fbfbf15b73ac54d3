"""``conv_roofline.pretrain``: The pretrain step's convolutions: their least time, % of their device time."""

from bmk.readers import conv_roofline as read  # noqa: F401
