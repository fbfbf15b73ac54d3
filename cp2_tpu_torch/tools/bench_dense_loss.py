"""Dense-loss crossover: the plain formula against the hand-written kernel.

Twin of ``tools/bench_dense_loss.py`` with its flags: value and gradient
with respect to both q and k of the CP2 dense loss alone, at the lemon
resolution (512² → S² = 1024, C = 128, T = 0.2) across batch sizes, for
the plain version (``ops/dense_loss.py::dense_pair_loss_reference``,
which forms the (N, S², S²) logits) and for ``dense_pair_loss``, which on
the card launches the kernels of ``csrc/dense_loss.cu`` (float32 operands
as 3xTF32; the backward with dk, which no CLI path asks for).  Inputs are
the JAX tool's, drawn from ``np.random.RandomState(0)`` for each run.

    python -m cp2_tpu_torch.tools.bench_dense_loss [--s2 1024] [--c 128]

It prints ms per step and the peak device memory of each, and holds the
kernel's loss and gradients to the plain version's at every batch (loss
2e-5, gradients 1e-4, normwise relative: the float32 tolerance of the
dense-loss tests); a disagreement fails the run.  The last line is one
JSON object with every number.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from cp2_tpu_torch.parallel import resolve_device
from cp2_tpu_torch.utils import benchmarking as bm

LOSS_RTOL, GRAD_RTOL = 2e-5, 1e-4


def get_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--s2", type=int, default=1024)
    ap.add_argument("--c", type=int, default=128)
    ap.add_argument("--temp", type=float, default=0.2)
    ap.add_argument("--batches", type=int, nargs="+", default=[8, 32, 64, 128, 256])
    ap.add_argument("--steps", type=int, default=20)
    return ap.parse_args(argv)


def inputs(n: int, s2: int, c: int):
    """The JAX tool's q, k (unit rows) and masks (first pixel set), numpy."""
    r = np.random.RandomState(0)
    q = r.randn(n, s2, c).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    k = r.randn(n, s2, c).astype(np.float32)
    k /= np.linalg.norm(k, axis=-1, keepdims=True)
    a = (r.rand(n, s2) > 0.5).astype(np.float32)
    b = (r.rand(n, s2) > 0.5).astype(np.float32)
    a[:, 0] = b[:, 0] = 1.0
    return q, k, a, b


def max_rel(ours: torch.Tensor, ref: torch.Tensor) -> float:
    """max |ours - ref| over max |ref|."""
    return float((ours.double() - ref.double()).abs().max() / ref.double().abs().max())


def run(device, args) -> dict:
    """Both versions at every batch on ``device``; returns the JSON line's
    dict, and raises where the kernel disagrees with the plain version."""
    from cp2_tpu_torch.ops import dense_loss as dl

    device = resolve_device(device)
    dl.reset_launch_counts()
    calls = [0]

    def one(fn, n, label):
        q, k, a, b = (torch.from_numpy(x).to(device) for x in inputs(n, args.s2, args.c))
        q.requires_grad_()
        k.requires_grad_()

        def value_and_grad():
            if fn is dl.dense_pair_loss:
                calls[0] += 1
            loss = fn(q, k, a, b, args.temp)
            return (loss, *torch.autograd.grad(loss, (q, k)))

        bm.reset_peak(device)
        out = value_and_grad()
        dt = bm.seconds(value_and_grad, args.steps, device) / args.steps
        peak = bm.peak_mib(device)
        print(f"  {label} n={n}: {dt * 1e3:8.2f} ms/step  loss={out[0].item():.4f}  "
              f"peak_mem={peak} MiB", flush=True)
        return dt, peak, [t.detach() for t in out]

    by_batch, problems = {}, []
    for n in args.batches:
        print(f"batch {n} (S2={args.s2}, C={args.c}):", flush=True)
        t_plain, peak_plain, ref = one(dl.dense_pair_loss_reference, n, "plain")
        t_kernel, peak_kernel, got = one(dl.dense_pair_loss, n, "kernel")
        errs = [abs(got[0].item() - ref[0].item()) / abs(ref[0].item()),
                max_rel(got[1], ref[1]), max_rel(got[2], ref[2])]
        print(f"  speedup: {t_plain / t_kernel:.2f}x; kernel vs plain: loss {errs[0]:.2e}, "
              f"dq {errs[1]:.2e}, dk {errs[2]:.2e}", flush=True)
        if errs[0] > LOSS_RTOL or max(errs[1:]) > GRAD_RTOL:
            problems.append(f"n={n}: loss {errs[0]:.2e}, dq {errs[1]:.2e}, dk {errs[2]:.2e}")
        by_batch[str(n)] = {
            "plain_ms": round(t_plain * 1e3, 4), "kernel_ms": round(t_kernel * 1e3, 4),
            "plain_peak_mib": peak_plain, "kernel_peak_mib": peak_kernel,
            "speedup": round(t_plain / t_kernel, 3), "loss_rel": errs[0], "dq_rel": errs[1],
            "dk_rel": errs[2]}
    bm.print_launches(calls[0])
    if problems:
        raise SystemExit("the kernel disagrees with the plain version: " + "; ".join(problems))
    return {"metric": "dense_loss_value_and_grad_ms", "s2": args.s2, "c": args.c,
            "temp": args.temp, "steps": args.steps, "by_batch": by_batch,
            "device": bm.card_line(device)}


def main(argv=None) -> int:
    print(json.dumps(run("cuda", get_args(argv))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
