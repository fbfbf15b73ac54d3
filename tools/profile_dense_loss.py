#!/usr/bin/env python3
"""Device time of each CUDA kernel of the port's dense pair loss, by name.

    python3 tools/profile_dense_loss.py [--iters 20]

At the five shapes of ``chip_smoke.py`` (float32 operands, T = 1) it
profiles ``--iters`` calls of the forward and of the step's backward (dq
only) with ``torch.profiler`` and prints, per call, the device time of
every kernel those calls launched, so that a forward made of several
kernels shows each one's share. Beside it, the whole call's time by CUDA
events, and the card's name and power limit.

It reads only the wrapper and ``chip_smoke.py``'s inputs, so a copy of it
in an older checkout measures that tree's kernels by device time too,
where its ``chip_smoke.py`` times eager calls only: run it in both trees
in one call to compare them.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import SHAPES, cuda_ms, dense_inputs, gpu_line  # noqa: E402


def short_name(kernel: str) -> str:
    """``void (anonymous namespace)::fwd_tiles<float, 128>(...)`` -> ``fwd_tiles<float, 128>``."""
    return kernel.replace("void ", "").replace("(anonymous namespace)::", "").split("(")[0]


def kernel_ms(fn, iters):
    """{kernel name: device ms per call of ``fn``} over ``iters`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / iters
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_dense_loss: no CUDA device", file=sys.stderr)
        return 1
    from cp2_tpu_torch.ops import dense_loss as dl

    print(f"device: {gpu_line()}")
    for (n, s2, c) in SHAPES:
        ops = dl.prepare_operands(*dense_inputs(n, s2, c, seed=s2 + c), torch.float32)
        _, lse = dl.fwd_kernel(*ops, 1.0)
        g = torch.ones((), device="cuda")
        calls = {
            "fwd": lambda: dl.fwd_kernel(*ops, 1.0),
            "bwd_dq": lambda: dl.bwd_kernel(*ops, lse, g, 1.0, need_dk=False),
        }
        for what, fn in calls.items():
            by_kernel = kernel_ms(fn, args.iters)
            total = cuda_ms(fn, iters=args.iters)
            parts = ", ".join(f"{short_name(k)} {v:.4f}"
                              for k, v in sorted(by_kernel.items(), key=lambda kv: -kv[1]))
            print(f"N={n} S2={s2} C={c} {what:6s}: {total:.4f} ms by events | {parts}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
