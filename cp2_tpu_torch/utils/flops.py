"""FLOP counts, counted as XLA counts them; the bf16 peak of NVIDIA
cards; MFU.

The JAX tools take their MFU from XLA's count of the compiled step
(``jitted.cost_analysis()["flops"]``, ``bench.py:195-209``).  PyTorch has
no compiled program to ask, so the count here is
``torch.utils.flop_counter.FlopCounterMode`` with XLA's rules where its
default formulas differ:

* **Convolutions** count only the (output, tap) pairs that read inside
  the input: ``2 · N · C_out · C_in/groups · Π_axes pairs``.  The default
  formula counts every tap, also those that read padding; at the ASPP's
  dilations 6, 12 and 18 on a 14x14 grid most do (at 18 only the centre
  tap reads the image), and the default count of the flagship forward is
  41 % above XLA's.  The backward counts the input gradient and the
  weight gradient at one forward each, and only those its
  ``output_mask`` asks for (the image needs no gradient, so the stem's is
  not counted, as XLA drops it).
* **Products** (``mm``, ``bmm``, ``addmm``, ``einsum``) keep torch's
  formulas, which are XLA's ``2 · M · N · K``.
* **The dense pair loss** counts by the formulas its custom ops register
  (``ops/dense_loss.py``): ``2 · N · S² · S² · C`` forward and again for
  each gradient, whether the kernel or its plain version runs.
* **Elementwise work is not counted**; XLA counts it, which puts XLA's
  count of the flagship forward about 4 % above this one.

The tools that build a step also count it from its configuration alone
(``tools/bench_pretrain_variant.py::step_flops``,
``tools/bench_finetune.py::step_flops``): one pass on the meta device,
shapes only.  They also count the first step they run, on the card, and
the two must agree.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode, conv_flop_count

aten = torch.ops.aten

# dense bf16 tensor-core peaks without sparsity (NVIDIA's H100 datasheet);
# the first tag the card's name contains wins
_PEAK_BF16 = (
    ("h100 nvl", 835e12),
    ("h100 pcie", 756e12),
    ("h100", 989.4e12),  # SXM5: "NVIDIA H100 80GB HBM3"
)


def peak_bf16_flops(name: str) -> Optional[float]:
    """Dense bf16 peak FLOP/s of an NVIDIA card by its name
    (``torch.cuda.get_device_name``); ``None`` for a card not in the table."""
    name = name.lower()
    for tag, peak in _PEAK_BF16:
        if tag in name:
            return peak
    return None


def mfu(flops_per_step: Optional[float], steps: int, seconds: float,
        peak: Optional[float]) -> Optional[float]:
    """The share of ``peak`` that ``steps`` steps of ``flops_per_step``
    reach in ``seconds``; ``None`` without a count or a peak."""
    if not flops_per_step or not peak:
        return None
    return flops_per_step * steps / seconds / peak


# ---------------------------------------------------------------------------
# XLA's rules
# ---------------------------------------------------------------------------

def _per_axis(value, dims: int) -> Tuple[int, ...]:
    value = tuple(value) if isinstance(value, (list, tuple)) else (value,)
    return value * dims if len(value) == 1 else value


def valid_pairs(size: int, out: int, kernel: int, stride: int, padding: int,
                dilation: int) -> int:
    """The (output, tap) pairs of one axis whose input index
    ``o·stride − padding + t·dilation`` lies in ``[0, size)``."""
    pairs = 0
    for t in range(kernel):
        offset = t * dilation - padding
        lo = max(0, -(offset // stride))  # ceil(-offset / stride)
        hi = min(out - 1, (size - 1 - offset) // stride)
        pairs += max(0, hi - lo + 1)
    return pairs


def conv_flops(x_shape: Sequence[int], w_shape: Sequence[int], out_shape: Sequence[int],
               stride, padding, dilation, transposed: bool = False) -> int:
    """XLA's count of one convolution: ``2 · N · C_out · C_in/groups`` times
    the product over the spatial axes of ``valid_pairs``.  A transposed
    convolution keeps torch's formula (the port runs none)."""
    if transposed:
        return conv_flop_count(list(x_shape), list(w_shape), list(out_shape), transposed=True)
    dims = len(w_shape) - 2
    stride, padding, dilation = (_per_axis(v, dims) for v in (stride, padding, dilation))
    pairs = 1
    for i in range(dims):
        pairs *= valid_pairs(x_shape[2 + i], out_shape[2 + i], w_shape[2 + i],
                             stride[i], padding[i], dilation[i])
    return 2 * x_shape[0] * w_shape[0] * w_shape[1] * pairs


def _conv_rule(x_shape, w_shape, _bias, stride, padding, dilation, transposed, *args,
               out_shape=None, **kwargs) -> int:
    return conv_flops(x_shape, w_shape, out_shape, stride, padding, dilation, transposed)


def _conv_backward_rule(grad_out_shape, x_shape, w_shape, _bias, stride, padding, dilation,
                        transposed, _output_padding, _groups, output_mask, out_shape=None,
                        **kwargs) -> int:
    """The input gradient and the weight gradient, each at one forward,
    where ``output_mask`` asks for them; the bias gradient is a sum."""
    one = conv_flops(x_shape, w_shape, grad_out_shape, stride, padding, dilation, transposed)
    return one * (int(output_mask[0]) + int(output_mask[1]))


XLA_RULES = {
    aten.convolution: _conv_rule,
    aten._convolution: _conv_rule,
    aten.convolution_backward: _conv_backward_rule,
}


def flop_counter() -> FlopCounterMode:
    """A ``FlopCounterMode`` with XLA's rules (``XLA_RULES``), silent."""
    return FlopCounterMode(display=False, custom_mapping=XLA_RULES)


def count_flops(fn: Callable, *args, **kwargs) -> Tuple[Any, int]:
    """``(fn(*args, **kwargs), its FLOPs)``; a backward inside ``fn`` counts."""
    with flop_counter() as counter:
        out = fn(*args, **kwargs)
    return out, counter.get_total_flops()


__all__ = [
    "XLA_RULES", "conv_flops", "count_flops", "flop_counter", "mfu", "peak_bf16_flops",
    "valid_pairs",
]
