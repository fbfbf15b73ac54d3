"""``dense_loss_roofline``: the CP2 dense pair loss (forward and query-gradient
passes): its least time from (N, S², C), % of its kernels' device time."""

from bmk.readers import dense_loss_roofline as read  # noqa: F401
