"""Microbenchmark: the ASPP's dilated convolutions at the OS16 grid (14x14).

Twin of ``tools/bench_dilated_conv.py``: forward and backward (the
weight's gradient of the sum of squares, as the JAX tool takes it) of a
3x3 convolution at (32, 2048, 14, 14) -> 512, bfloat16, for dilations 6,
12 and 18, through ``models/layers.py::conv2d`` (cuDNN) with the input in
contiguous NCHW and in channels-last.  ``BENCH_D2=1`` times the ResNet
stage-4 3x3 convolutions at dilation 2 (512 -> 512) instead.  The inputs
are the JAX tool's, drawn from ``np.random.RandomState(0)``.

At a 14x14 grid most of a dilated tap reads padding: the useful share of
the taps (``utils/flops.py``'s count over the count of every tap) is about
51 % at d = 6 and 18 % at d = 12.  The tool prints it and the rate on
useful FLOPs (forward and weight gradient).

The JAX tool also times a tap-split rewrite of these convolutions, which
the JAX package needs on the TPU; the port runs the plain convolution
(ROADMAP.md, ground rules: the rewrites that exist only to get around TPU
weaknesses are not copied), so this tool times only what the port runs.

    python -m cp2_tpu_torch.tools.bench_dilated_conv
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch
from torch.utils.flop_counter import conv_flop_count

from cp2_tpu_torch.parallel import resolve_device
from cp2_tpu_torch.utils import benchmarking as bm


def shapes():
    """(C_in, C_out, dilations) of the run: the ASPP's, or with BENCH_D2=1
    the ResNet stage-4 3x3 convolutions'."""
    if os.environ.get("BENCH_D2", "0") == "1":
        return 512, 512, (2,)
    return 2048, 512, (6, 12, 18)


def run(device, *, n: int = 32, hw: int = 14, cin: int = 2048, cout: int = 512,
        dilations=(6, 12, 18), steps: int = 30) -> dict:
    """Every dilation and layout on ``device``; returns the JSON line's dict."""
    from cp2_tpu_torch.models.layers import conv2d
    from cp2_tpu_torch.ops import dense_loss
    from cp2_tpu_torch.utils.flops import conv_flops, peak_bf16_flops

    device = resolve_device(device)
    dense_loss.reset_launch_counts()
    r = np.random.RandomState(0)
    if (cin, cout) != (2048, 512):
        # the JAX tool draws the ASPP's tensors first, then these
        r.randn(n, hw, hw, 2048)
        r.randn(3, 3, 2048, 512)
    x = torch.from_numpy(r.randn(n, hw, hw, cin).astype(np.float32)).to(device).bfloat16()
    kern = torch.from_numpy(r.randn(3, 3, cin, cout).astype(np.float32) * 0.01)
    layouts = {"nchw": x.permute(0, 3, 1, 2).contiguous(),
               "channels_last": x.permute(0, 3, 1, 2)}
    peak = peak_bf16_flops(bm.device_name(device))
    out = {"metric": "dilated_conv_us_per_fwd_bwd", "shape": [n, cin, hw, hw, cout],
           "by_dilation": {}}
    calls = 0
    for d in dilations:
        conv = torch.nn.Conv2d(cin, cout, 3, padding=d, dilation=d, bias=False).to(device)
        with torch.no_grad():
            conv.weight.copy_(kern.permute(3, 2, 0, 1))
        y_shape = (n, cout, hw, hw)
        every = conv_flop_count([n, cin, hw, hw], [cout, cin, 3, 3], list(y_shape))
        useful = conv_flops((n, cin, hw, hw), (cout, cin, 3, 3), y_shape, 1, d, d)
        print(f"dilation {d} @ {hw}x{hw}, {cin}->{cout}: useful share of the taps "
              f"{useful / every:.3f}", flush=True)
        row = {"useful_share": round(useful / every, 4)}
        for name, xl in layouts.items():
            def fwd_bwd():
                loss = (conv2d(conv, xl, torch.bfloat16).float() ** 2).sum()
                return loss, torch.autograd.grad(loss, conv.weight)[0]

            fwd_bwd = bm.Counted(fwd_bwd)
            loss, _ = fwd_bwd()
            dt = bm.seconds(fwd_bwd, steps, device) / steps
            calls += fwd_bwd.calls
            rate = 2 * useful / dt  # forward and the weight's gradient
            print(f"  {name:13s} d={d}: {dt * 1e6:8.0f} us/fwd+bwd  loss={loss.item():.1f}  "
                  f"{rate / 1e12:7.1f} useful TFLOP/s", flush=True)
            row[name] = {"us": round(dt * 1e6, 1), "useful_tflops": round(rate / 1e12, 3),
                         "useful_share_of_peak": None if peak is None else round(rate / peak, 4)}
        out["by_dilation"][str(d)] = row
    bm.print_launches(calls)
    out["device"] = bm.card_line(device)
    return out


def main(argv=None) -> int:
    cin, cout, dilations = shapes()
    print(json.dumps(run("cuda", cin=cin, cout=cout, dilations=dilations)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
