"""Microbenchmark: the ASPP's dilated convolutions at the two cells' grids.

Twin of ``tools/bench_dilated_conv.py``: a 3x3 convolution 2048 -> 512 in
bfloat16 for dilations 6, 12 and 18, at the pretrain's (64, 2048, 14, 14)
(224², output stride 16) and the finetune's (16, 2048, 22, 22) (352²),
forward and both gradients (the input's and the weight's, as the training
step takes them), each way it can run:

* ``plain``: ``F.conv2d(..., dilation=d, padding=d)``, cuDNN's dilated
  convolution;
* ``split``: the same convolution as the sum of its in-bounds taps
  (``models/layers.py::_TapSplitConv3x3``), also where ``conv2d`` would
  not take it, so the two can be weighed at every dilation.

``engages`` says which of the two ``models/layers.py::conv2d`` runs
(``tap_split_engages``).  ``BENCH_D2=1`` times the ResNet stage-4 3x3
convolutions at dilation 2 (512 -> 512) instead.  The inputs are drawn
from ``np.random.RandomState(0)``.

At a 14x14 grid most of a dilated tap reads padding: the useful share of
the taps (``utils/flops.py``'s count over the count of every tap) is about
51 % at d = 6 and 18 % at d = 12.  The tool prints it and the rate on
useful FLOPs (forward and both gradients: three times the forward's).

    python -m cp2_tpu_torch.tools.bench_dilated_conv
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import conv_flop_count

from cp2_tpu_torch.parallel import resolve_device
from cp2_tpu_torch.utils import benchmarking as bm

SHAPES = ((64, 14), (16, 22))  # (batch, grid) of the pretrain and finetune cells


def shapes():
    """(C_in, C_out, dilations) of the run: the ASPP's, or with BENCH_D2=1
    the ResNet stage-4 3x3 convolutions'."""
    if os.environ.get("BENCH_D2", "0") == "1":
        return 512, 512, (2,)
    return 2048, 512, (6, 12, 18)


def run(device, *, shapes=SHAPES, cin: int = 2048, cout: int = 512,
        dilations=(6, 12, 18), steps: int = 30) -> dict:
    """Every shape, dilation and path on ``device``; returns the JSON
    line's dict."""
    from cp2_tpu_torch.models import layers
    from cp2_tpu_torch.ops import dense_loss
    from cp2_tpu_torch.utils.flops import conv_flops, peak_bf16_flops

    device = resolve_device(device)
    dense_loss.reset_launch_counts()
    peak = peak_bf16_flops(bm.device_name(device))
    out = {"metric": "dilated_conv_us_per_fwd_bwd", "cin": cin, "cout": cout, "by_shape": {}}
    calls = 0
    for n, hw in shapes:
        r = np.random.RandomState(0)
        x = torch.from_numpy(r.randn(n, cin, hw, hw).astype(np.float32)).to(device).bfloat16()
        gy = torch.from_numpy(r.randn(n, cout, hw, hw).astype(np.float32)).to(device).bfloat16()
        kern = torch.from_numpy(r.randn(cout, cin, 3, 3).astype(np.float32) * 0.01)
        rows = {}
        for d in dilations:
            conv = torch.nn.Conv2d(cin, cout, 3, padding=d, dilation=d, bias=False).to(device)
            with torch.no_grad():
                conv.weight.copy_(kern)
            y_shape = (n, cout, hw, hw)
            every = conv_flop_count([n, cin, hw, hw], [cout, cin, 3, 3], list(y_shape))
            useful = conv_flops((n, cin, hw, hw), (cout, cin, 3, 3), y_shape, 1, d, d)
            engages = layers.tap_split_engages(conv, x)
            print(f"{n}x{cin}x{hw}x{hw} -> {cout}, dilation {d}: useful share of the taps "
                  f"{useful / every:.3f}; conv2d takes the {'split' if engages else 'plain'} "
                  "path", flush=True)
            row = {"useful_share": round(useful / every, 4), "engages": engages}
            paths = {
                "plain": lambda xi: F.conv2d(xi, conv.weight.bfloat16(), None, 1, d, d),
                "split": lambda xi: layers._TapSplitConv3x3.apply(xi, conv.weight, conv.dilation),
            }
            for name, conv_fn in paths.items():
                def fwd_bwd(conv_fn=conv_fn):
                    xi = x.detach().requires_grad_()
                    y = conv_fn(xi)
                    return torch.autograd.grad(y, (xi, conv.weight), gy)

                fwd_bwd = bm.Counted(fwd_bwd)
                fwd_bwd()
                dt = bm.seconds(fwd_bwd, steps, device) / steps
                calls += fwd_bwd.calls
                rate = 3 * useful / dt  # the forward and both gradients
                print(f"  {name:5s} d={d}: {dt * 1e6:8.0f} us/fwd+bwd  "
                      f"{rate / 1e12:7.1f} useful TFLOP/s", flush=True)
                row[name] = {"us": round(dt * 1e6, 1), "useful_tflops": round(rate / 1e12, 3),
                             "useful_share_of_peak": None if peak is None
                             else round(rate / peak, 4)}
            row["split_speedup"] = round(row["plain"]["us"] / row["split"]["us"], 3)
            rows[str(d)] = row
        out["by_shape"][f"{n}x{hw}x{hw}"] = rows
    bm.print_launches(calls)
    out["device"] = bm.card_line(device)
    return out


def main(argv=None) -> int:
    cin, cout, dilations = shapes()
    print(json.dumps(run("cuda", cin=cin, cout=cout, dilations=dilations)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
