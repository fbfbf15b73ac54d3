"""Shipped model configs (copies of ``cp2_tpu/configs``)."""
