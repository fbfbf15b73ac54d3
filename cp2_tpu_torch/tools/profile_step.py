"""Capture and summarize a profile of the pretrain or finetune step on an
NVIDIA card.

Twin of ``tools/profile_step.py`` with its flags and ``BENCH_*``
variables: it runs the step of ``cp2_tpu_torch.tools.bench_pretrain_variant``
(``--task pretrain``: ``BENCH_VARIANT``, default CP2, on its config;
``BENCH_BATCH`` 32, ``BENCH_HW`` 224, ``BENCH_METRICS_LEVEL`` 0) or of
``cp2_tpu_torch.tools.bench_finetune`` (``--task finetune``: batch 16 at
352² unless ``BENCH_BATCH`` / ``BENCH_HW`` say otherwise), warms it up for
2 steps, and profiles ``--steps`` steps under ``torch.profiler`` with CPU
and CUDA activities.  The Chrome trace goes to ``<--out>/trace.json``.

The summary, read back from that trace (``--summarize-only`` reads an
earlier one), gives the device time by category and by kernel, the share
of the profiled window in which some kernel ran, and the dense-loss
kernels' time; the last line is one JSON object with it.  An earlier
``LAUNCHES`` line gives the dense-loss kernels' launches beside the steps
run.

    python -m cp2_tpu_torch.tools.profile_step [--task pretrain] [--steps 6]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from cp2_tpu_torch.parallel import resolve_device
from cp2_tpu_torch.utils import benchmarking as bm

TRACE = "trace.json"

# kernel name fragment -> category, first match wins (names lower-cased)
CATEGORIES = (
    ("dense loss (csrc/dense_loss.cu)", ("::fwd_kernel<", "::bwd_kernel<")),
    ("convolution", ("conv", "dgrad", "wgrad", "fprop", "implicit_gemm")),
    ("matrix product", ("gemm", "cutlass", "cublas", "matmul")),
    ("batch norm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw", "welford")),
    ("reduction", ("reduce",)),
    ("layout and copy", ("copy", "transpose", "nchw", "nhwc", "cat_", "index", "gather",
                         "scatter", "memcpy", "memset")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def get_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--out", default=os.path.join(bm.ROOT, "work_dirs", "cp2_profile"))
    ap.add_argument("--summarize-only", action="store_true")
    ap.add_argument("--task", choices=("pretrain", "finetune"), default="pretrain")
    return ap.parse_args(argv)


def category(name: str) -> str:
    low = name.lower()
    for label, fragments in CATEGORIES:
        if any(f in low for f in fragments):
            return label
    return "other"


def summarize(log_dir: str, top: int = 25) -> dict:
    """Device time by category and by kernel from ``<log_dir>/trace.json``,
    the busy share of the profiled window, and the dense-loss kernels'
    time; prints them and returns them."""
    with open(os.path.join(log_dir, TRACE)) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    start = min(e["ts"] for e in events)
    window_us = max(e["ts"] + e["dur"] for e in events) - start
    busy_us, reach = 0.0, start
    for e in sorted(device, key=lambda e: e["ts"]):  # the union of the intervals
        end = e["ts"] + e["dur"]
        busy_us += max(0.0, end - max(e["ts"], reach))
        reach = max(reach, end)
    by_kernel, by_category = {}, {}
    for e in device:
        by_kernel[e["name"]] = by_kernel.get(e["name"], 0.0) + e["dur"]
        label = category(e["name"])
        by_category[label] = by_category.get(label, 0.0) + e["dur"]
    total = sum(by_kernel.values()) or 1.0
    summary = {
        "window_ms": round(window_us / 1e3, 3),
        "device_ms": round(sum(by_kernel.values()) / 1e3, 3),
        "busy_share": round(busy_us / window_us, 4) if device else None,
        "dense_loss_ms": round(by_category.get(CATEGORIES[0][0], 0.0) / 1e3, 4),
        "by_category_ms": {k: round(v / 1e3, 3) for k, v in
                           sorted(by_category.items(), key=lambda kv: -kv[1])},
        "top_kernels": [{"kernel": k[:160], "ms": round(v / 1e3, 3)} for k, v in
                        sorted(by_kernel.items(), key=lambda kv: -kv[1])[:top]],
    }
    print(f"== profile: window {summary['window_ms']:.1f} ms, device time "
          f"{summary['device_ms']:.1f} ms, busy share {summary['busy_share']} ==")
    for label, ms in summary["by_category_ms"].items():
        print(f"  {100 * ms * 1e3 / total:6.2f}%  {ms:9.3f} ms  {label}")
    for row in summary["top_kernels"]:
        print(f"      {100 * row['ms'] * 1e3 / total:6.2f}%  {row['ms']:9.3f} ms  "
              f"{row['kernel'][:110]}")
    print(f"dense pair-loss kernels: {summary['dense_loss_ms']:.4f} ms")
    return summary


def run(model_cfg: dict, device, *, task: str, steps: int, out: str, batch: int, hw: int,
        variant: str = "CP2", metrics_level: int = 0) -> dict:
    """Profile ``steps`` steps of ``task`` on ``device`` into ``out``;
    returns the summary with the run's settings."""
    from torch.profiler import ProfilerActivity, profile

    from cp2_tpu_torch.ops import dense_loss
    from cp2_tpu_torch.tools import bench_finetune, bench_pretrain_variant

    device = resolve_device(device)
    dense_loss.reset_launch_counts()
    if task == "finetune":
        call, _ = bench_finetune.build(model_cfg, device, 2, batch, hw)
        counted = call
    else:
        call, counted = bench_pretrain_variant.build(model_cfg, device, variant, "DEEPLABV3",
                                                     batch, hw, metrics_level=metrics_level)
    for _ in range(2):  # warm up outside the trace
        loss = call()
    loss.item()
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=activities) as prof:
        for _ in range(steps):
            loss = call()
        loss.item()
        bm.synchronize(device)
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, TRACE))
    bm.print_launches(counted.calls)
    summary = summarize(out)
    return {"metric": "profile", "task": task, "variant": variant if task == "pretrain" else None,
            "steps": steps, "batch": batch, "hw": hw, **summary,
            "device": bm.card_line(device)}


def main(argv=None) -> int:
    args = get_args(argv)
    if args.summarize_only:
        print(json.dumps({"metric": "profile", **summarize(args.out)}), flush=True)
        return 0
    env = os.environ.get
    finetune = args.task == "finetune"
    variant = env("BENCH_VARIANT", "CP2")
    from cp2_tpu_torch.tools.bench_pretrain_variant import config_name

    result = run(bm.model_config("config_finetune.py" if finetune else config_name(variant)),
                 "cuda", task=args.task, steps=args.steps, out=args.out,
                 batch=int(env("BENCH_BATCH", "16" if finetune else "32")),
                 hw=int(env("BENCH_HW", "352" if finetune else "224")), variant=variant,
                 metrics_level=int(env("BENCH_METRICS_LEVEL", "0")))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
