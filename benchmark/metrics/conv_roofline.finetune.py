"""``conv_roofline.finetune``: The finetune step's convolutions: their least time, % of the device time of the kernels launched by the convolution ops and the tap split."""

from bmk.readers import conv_roofline as read  # noqa: F401
