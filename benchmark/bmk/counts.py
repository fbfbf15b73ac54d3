"""Operations and bytes of a step, counted from shapes on the meta device,
and the card's peaks.

FLOPs are counted as XLA counts a compiled step, by the rules frozen here
from ``cp2_tpu_torch/utils/flops.py``: a convolution counts only the
(output, tap) pairs that read inside its input, its backward the input and
weight gradients at one forward each where they are asked for, products
``2·M·N·K``, elementwise work nothing.  The step counted is the
reference's (``reference/``) at the cell's shapes, so a count does not
change with what implements the step.

Each convolution's least time is the larger of its FLOPs over the bf16
peak and its bytes (each input, weight and output once, at the bytes of
the configuration's compute type) over the memory bandwidth; the
convolutions' roofline divides their sum by the trace's convolution time.
The dense pair loss's least time is taken from (N, S², C): its forward,
and the backward pass that forms the query gradient (the similarities
formed again, then the product), at the TF32 tensor-core peak, which
bounds float32 operands however the kernel splits them.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, conv_flop_count

aten = torch.ops.aten

# NVIDIA's data sheet of the H100 SXM5, dense rates without sparsity, at
# the full 700 W; by the name ``torch.cuda.get_device_name`` gives
PEAKS = {"NVIDIA H100 80GB HBM3": dict(bf16=989.4e12, tf32=494.7e12, bytes=3.35e12)}


def peaks(name: str) -> Optional[dict]:
    """The card's peaks, or ``None`` for a card not in the table (its
    shares of a peak are then not read)."""
    return PEAKS.get(name)


def valid_pairs(size, out, kernel, stride, padding, dilation) -> int:
    pairs = 0
    for t in range(kernel):
        offset = t * dilation - padding
        lo = max(0, -(offset // stride))
        hi = min(out - 1, (size - 1 - offset) // stride)
        pairs += max(0, hi - lo + 1)
    return pairs


def _per_axis(value, dims):
    value = tuple(value) if isinstance(value, (list, tuple)) else (value,)
    return value * dims if len(value) == 1 else value


def conv_flops(x_shape, w_shape, out_shape, stride, padding, dilation, transposed=False):
    if transposed:
        return conv_flop_count(list(x_shape), list(w_shape), list(out_shape), transposed=True)
    dims = len(w_shape) - 2
    stride, padding, dilation = (_per_axis(v, dims) for v in (stride, padding, dilation))
    pairs = 1
    for i in range(dims):
        pairs *= valid_pairs(x_shape[2 + i], out_shape[2 + i], w_shape[2 + i], stride[i],
                             padding[i], dilation[i])
    return 2 * x_shape[0] * w_shape[0] * w_shape[1] * pairs


def _conv_rule(x_shape, w_shape, _bias, stride, padding, dilation, transposed, *args,
               out_shape=None, **kwargs):
    return conv_flops(x_shape, w_shape, out_shape, stride, padding, dilation, transposed)


def _conv_backward_rule(grad_out_shape, x_shape, w_shape, _bias, stride, padding, dilation,
                        transposed, _output_padding, _groups, output_mask, out_shape=None,
                        **kwargs):
    one = conv_flops(x_shape, w_shape, grad_out_shape, stride, padding, dilation, transposed)
    return one * (int(output_mask[0]) + int(output_mask[1]))


XLA_RULES = {aten.convolution: _conv_rule, aten._convolution: _conv_rule,
             aten.convolution_backward: _conv_backward_rule}


class ConvLedger(TorchDispatchMode):
    """Each convolution's (FLOPs, bytes) by XLA's rule, forward and
    backward parts apart."""

    def __init__(self, bytes_per_element: int):
        super().__init__()
        self.bpe = bytes_per_element
        self.parts = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func in (aten.convolution.default, aten._convolution.default):
            x, w = args[0], args[1]
            stride, padding, dilation = args[3], args[4], args[5]
            f = conv_flops(x.shape, w.shape, out.shape, stride, padding, dilation)
            self.parts.append((f, self.bpe * (x.numel() + w.numel() + out.numel())))
        elif func is aten.convolution_backward.default:
            gy, x, w = args[0], args[1], args[2]
            stride, padding, dilation, mask = args[4], args[5], args[6], args[10]
            f = conv_flops(x.shape, w.shape, gy.shape, stride, padding, dilation)
            if mask[0]:
                self.parts.append((f, self.bpe * (gy.numel() + w.numel() + x.numel())))
            if mask[1]:
                self.parts.append((f, self.bpe * (x.numel() + gy.numel() + w.numel())))
        return out

    def bound_s(self, peak: dict) -> float:
        return sum(max(f / peak["bf16"], b / peak["bytes"]) for f, b in self.parts)


def count(step: Callable[[], None], bytes_per_element: int) -> Tuple[int, ConvLedger]:
    """(FLOPs of ``step()``, its convolutions' ledger); ``step`` runs on
    meta tensors."""
    ledger = ConvLedger(bytes_per_element)
    with FlopCounterMode(display=False, custom_mapping=XLA_RULES) as counter:
        with ledger:
            step()
    return counter.get_total_flops(), ledger


def dense_loss_bound_s(n: int, s2: int, c: int, peak: dict, operand_bytes: int = 4) -> float:
    """Least seconds of the dense pair loss's forward and query-gradient
    passes at (N, S², C)."""
    product = 2 * n * s2 * s2 * c
    qk, row = n * s2 * c * operand_bytes, n * s2 * 4
    fwd = max(product / peak["tf32"], (2 * qk + 3 * row) / peak["bytes"])
    dq = max(2 * product / peak["tf32"], (3 * qk + 3 * row) / peak["bytes"])
    return fwd + dq
