"""Attribute the cost of the level-1 scalar-metric block on an NVIDIA card.

Twin of ``tools/bench_metrics.py`` with its flags: the individual stat
kernels at their shapes (``dense_loss_stats`` of (N, S², S²) logits,
``_instance_stat_metrics`` against the (N, K) queue logits,
``get_masked_correlation_map`` of (N, S, S) id maps), and with
``--full-step`` the CP2 pretrain step (``config_pretrain.py``, a bfloat16
model, on-device augmentation from raw 256² uint8 frames, 224²) at
``metrics_level`` 0 and 1, and the difference: the metric block's share
of the logged step.  The stat kernels' inputs are drawn from a seeded
``torch.Generator`` by the JAX tool's laws.

    python -m cp2_tpu_torch.tools.bench_metrics [--full-step]

It prints the JAX tool's lines, then one JSON line with every time, the
card's name and power limit; an earlier ``LAUNCHES`` line gives the
dense-loss kernels' launches beside the CP2 steps run.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from cp2_tpu_torch.parallel import resolve_device
from cp2_tpu_torch.utils import benchmarking as bm


def get_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--s", type=int, default=14, help="feature grid side")
    ap.add_argument("--k", type=int, default=65536, help="queue length")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--full-step", action="store_true",
                    help="also time the full CP2 train step at level 0/1")
    return ap.parse_args(argv)


def _time(fn, *args, device, steps=30, warmup=5) -> float:
    """Seconds of one call of ``fn(*args)``, after ``warmup``, without grad."""
    with torch.no_grad():
        for _ in range(warmup):
            fn(*args)
        return bm.seconds(lambda: fn(*args), steps, device) / steps


def kernel_times(args, device, results) -> None:
    from cp2_tpu_torch.ops.correlation import dense_loss_stats, get_masked_correlation_map
    from cp2_tpu_torch.ssl.objectives import _instance_stat_metrics

    n, s2, k = args.batch, args.s * args.s, args.k
    gen = torch.Generator(device=device).manual_seed(0)
    kw = dict(generator=gen, device=device)
    logits = torch.randn((n, s2, s2), **kw)
    labels = (torch.rand((n, s2, s2), **kw) < 0.1).float()
    l_neg = torch.randn((n, k), **kw)
    l_pos = torch.randn((n, 1), **kw)
    ids_a = torch.randint(0, 4096, (n, args.s, args.s), **kw).float()
    ids_b = torch.randint(0, 4096, (n, args.s, args.s), **kw).float()
    mask = torch.ones((n, args.s, args.s), device=device)
    results["dense_loss_stats"] = _time(dense_loss_stats, logits, labels, device=device,
                                        steps=args.steps)
    results["instance_stats"] = _time(_instance_stat_metrics, l_pos, l_neg, device=device,
                                      steps=args.steps)
    results["masked_corr_map"] = _time(get_masked_correlation_map, ids_a, ids_b, mask, mask,
                                       device=device, steps=args.steps)


def full_step_times(model_cfg: dict, args, device, results, hw: int = 224) -> int:
    """The CP2 step of ``bench_pretrain_variant`` at ``metrics_level`` 0
    and 1 (5 warm-up steps, then ``args.steps``); returns the steps run."""
    from cp2_tpu_torch.tools.bench_pretrain_variant import build

    steps_run = 0
    for lvl in (0, 1):
        call, step = build(model_cfg, device, "CP2", "DEEPLABV3", args.batch, hw,
                           metrics_level=lvl)
        for _ in range(5):
            loss = call()
        loss.item()
        results[f"full_step_level{lvl}"] = bm.seconds(call, args.steps, device) / args.steps
        steps_run += step.calls
    return steps_run


def run(model_cfg: dict, device, args, hw: int = 224) -> dict:
    """Every time of ``args`` on ``device``; prints the JAX tool's lines and
    returns the JSON line's dict."""
    from cp2_tpu_torch.ops import dense_loss

    device = resolve_device(device)
    dense_loss.reset_launch_counts()
    results = {}
    kernel_times(args, device, results)
    steps = full_step_times(model_cfg, args, device, results, hw) if args.full_step else 0
    bm.print_launches(steps)
    for name, sec in results.items():
        print(f"{name:24s} {sec * 1e3:9.3f} ms")
    out = {"metric": "metric_block_ms",
           "ms": {name: round(sec * 1e3, 4) for name, sec in results.items()}}
    if "full_step_level0" in results:
        d = results["full_step_level1"] - results["full_step_level0"]
        print(f"{'metric overhead':24s} {d * 1e3:9.3f} ms "
              f"({100 * d / results['full_step_level1']:.1f}% of level-1 step)")
        out.update(metric_overhead_ms=round(d * 1e3, 4),
                   metric_overhead_share=round(d / results["full_step_level1"], 4))
    out["device"] = bm.card_line(device)
    return out


def main(argv=None) -> int:
    print(json.dumps(run(bm.model_config("config_pretrain.py"), "cuda", get_args(argv))),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
