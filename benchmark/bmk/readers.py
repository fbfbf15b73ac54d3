"""What the per-layer readers share: each takes a ``trace.Reading`` and
returns the metric's value, or ``None`` when the run shows nothing to read
(no span of that name, no kernel of that category, a card without a peak
in ``counts.PEAKS``).

The generic ones take names or ``fnmatch`` patterns, so that a metric
file of a new configuration reads its own spans and ops in one line:

    def read(r):
        return readers.span_device_ms(r, "model.attention")

* ``span_device_ms``: device ms per step of what was launched inside
  spans of a name or pattern (``model.*``);
* ``span_host_ms``: host ms per step inside them;
* ``op_device_s``: device seconds of what was launched inside ops whose
  name matches a pattern (``aten::*convolution*``);
* ``roofline``: a least time from ``counts`` over the device time of what
  was launched inside the given ops or spans, each kernel once.
"""

from __future__ import annotations

from typing import Iterable, Optional

CONV_OPS = ("aten::*convolution*",)  # forward (aten::convolution, ...) and convolution_backward
CONV_SPANS = ("model.tap_split",)  # the program's convolutions run as their taps


def span_device_ms(r, name: str) -> Optional[float]:
    """Device ms per step of the kernels launched inside spans matching
    ``name``; ``None`` where they launched nothing."""
    seconds = r.device_s(spans=(name,))
    return seconds / r.steps * 1e3 if seconds > 0 and r.steps else None


def span_host_ms(r, name: str) -> Optional[float]:
    """Host ms per step inside spans matching ``name``; ``None`` without
    such a span."""
    seconds = r.span_host_s(name)
    return seconds / r.steps * 1e3 if seconds > 0 and r.steps else None


def op_device_s(r, *patterns: str) -> float:
    """Device seconds of the kernels launched inside ops matching any of
    ``patterns``."""
    return r.device_s(ops=patterns)


def roofline(r, key: str, ops: Iterable[str] = (), spans: Iterable[str] = ()) -> Optional[float]:
    """``counts[key]`` (a step's least seconds) × steps, % of the device
    time of the kernels launched inside ``ops`` or ``spans``."""
    seconds = r.device_s(ops=ops, spans=spans)
    if key not in r.counts or seconds <= 0:
        return None
    return r.counts[key] * r.steps / seconds * 100.0


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
    return span_device_ms(r, "augment")


def mfu(r) -> Optional[float]:
    """The window's steps' FLOPs per second, % of the card's bf16 peak."""
    if not r.peak:
        return None
    return r.counts["flops_per_step"] * r.steps / r.window_s / r.peak["bf16"] * 100.0


def conv_roofline(r) -> Optional[float]:
    """The convolutions' least time, % of the device time of every kernel
    launched inside a convolution op (forward or backward: cuDNN's own,
    its layout transposes, its workspace memsets) or inside the program's
    tap split (its band copies, GEMMs and sums), each kernel once, and
    not the kernels that carry convolution names, which leave all of
    those out."""
    return roofline(r, "conv_bound_s", ops=CONV_OPS, spans=CONV_SPANS)


def dense_loss_roofline(r) -> Optional[float]:
    """The dense pair loss's least time, % of its kernels' device time."""
    seconds = r.category_s("dense loss")
    if "dense_loss_bound_s" not in r.counts or seconds <= 0:
        return None
    return r.counts["dense_loss_bound_s"] * r.steps / seconds * 100.0


def device_idle(r) -> Optional[float]:
    """% of the window in which no kernel, copy or memset ran."""
    return (1.0 - r.busy_s() / r.window_s) * 100.0
