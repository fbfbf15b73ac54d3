"""What the per-layer readers share: each takes a ``trace.Reading`` and
returns the metric's value, or ``None`` when the run shows nothing to read
(no span of that name, no kernel of that category, a card without a peak
in ``counts.PEAKS``)."""

from __future__ import annotations

from typing import Optional


def loader_wait_ms(r) -> Optional[float]:
    """Host ms per step blocked on the next staged batch."""
    if not r.spans["loader_wait"]:
        return None
    return r.span_host_s("loader_wait") / r.steps * 1e3


def images_per_s(r) -> Optional[float]:
    """Images of the traced window's steps per second of the window."""
    return r.images / r.window_s if r.images else None


def augment_ms(r) -> Optional[float]:
    """Device ms per step of the kernels the augmentation launched."""
    seconds = r.span_device_s("augment")
    return seconds / r.steps * 1e3 if seconds > 0 else None


def mfu(r) -> Optional[float]:
    """The window's steps' FLOPs per second, % of the card's bf16 peak."""
    if not r.peak:
        return None
    return r.counts["flops_per_step"] * r.steps / r.window_s / r.peak["bf16"] * 100.0


def _roofline(r, key: str, label: str) -> Optional[float]:
    seconds = r.category_s(label)
    if key not in r.counts or seconds <= 0:
        return None
    return r.counts[key] * r.steps / seconds * 100.0


def conv_roofline(r) -> Optional[float]:
    """The convolutions' least time, % of their device time."""
    return _roofline(r, "conv_bound_s", "convolution")


def dense_loss_roofline(r) -> Optional[float]:
    """The dense pair loss's least time, % of its kernels' device time."""
    return _roofline(r, "dense_loss_bound_s", "dense loss")


def device_idle(r) -> Optional[float]:
    """% of the window in which no kernel, copy or memset ran."""
    return (1.0 - r.busy_s() / r.window_s) * 100.0
