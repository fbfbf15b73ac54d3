"""Benchmark: CP2 pretrain throughput (images/s per card) on an NVIDIA card.

Twin of the repo's ``bench.py``: the flagship configuration (CP2 dense
contrastive pretraining, dilated ResNet-50 + ASPP contrast head, 224x224,
a bfloat16 model, SGD at 1e-3) as the pretrain CLI's step, on-device
augmentation included, from raw uint8 frames of (hw + 32)² made exactly
as ``bench.py`` makes them, so both tools time the same bytes.

    python -m cp2_tpu_torch.bench

It reads ``bench.py``'s environment variables with the same defaults.
Two differ in meaning:

* ``BENCH_SCAN=K`` runs the steps one after another over K distinct
  batches (made as ``bench.py`` makes them): PyTorch has no ``lax.scan``
  dispatch to chain them into, as the pretrain CLI's ``--steps-per-call``
  says.  ``mfu`` is right at any K, since the count is per step.
* A non-empty ``BENCH_COMPILER_OPTIONS`` is refused: it passes options to
  XLA's compiler, and the eager step has no compiler to pass them to.

The device-only rate is the host clock around ``BENCH_STEPS`` steps after
one counted step and ``BENCH_WARMUP`` warm-up steps, ending in a device
synchronize.  ``model_flops_per_step`` is the counted step's FLOPs
(``utils/flops.py``: what XLA counts, less its elementwise work); ``mfu``
is that over the card's dense bf16 peak.  The end-to-end phases feed the
same step from three loader streams of JPEGs, through the loader the
pretrain CLI would choose here (the native pool if it builds, else the
Python loader) and ``DevicePrefetcher`` at depth 2; the raw-cache phase
runs with the native pool only.  The one JSON line has ``bench.py``'s keys
plus ``device`` (name and power limit), ``loader`` and
``peak_device_mib``; an earlier ``LAUNCHES`` line gives the dense-loss
kernels' launches beside the steps run.

Baseline note: ``vs_baseline`` keeps ``bench.py``'s formula,
images/s / (3 x 330).  330 images/s is the JAX package's assumed rate of
the reference PyTorch step on one A100; it is not a target for this card.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from cp2_tpu_torch.parallel import resolve_device
from cp2_tpu_torch.tools import bench_pretrain_variant
from cp2_tpu_torch.utils import benchmarking as bm

ASSUMED_REFERENCE_A100_IPS = 330.0
TARGET_MULTIPLIER = 3.0
STEP_SEED = 42  # bench.py's jax.random.PRNGKey(42)
E2E_SEED = 43


def raw_frames(batch: int, hw: int, no_aug: bool, r: np.random.RandomState) -> dict:
    """``bench.py``'s host arrays: uint8 frames of (hw + 32)², or with
    ``no_aug`` the pre-augmented batch; drawn from ``r`` in its order."""
    base = hw + 32
    if no_aug:
        ids = np.tile(np.arange(1, hw * hw + 1, dtype=np.int32).reshape(1, hw, hw),
                      (batch, 1, 1))
        bg = (r.rand(batch, hw, hw, 3)).astype(np.float32)
        bg[:, hw // 4: 3 * hw // 4, hw // 4: 3 * hw // 4, :] = 0.0
        return {
            "img_a": r.rand(batch, hw, hw, 3).astype(np.float32),
            "img_b": r.rand(batch, hw, hw, 3).astype(np.float32),
            "bg0": bg,
            "bg1": bg.copy(),
            "pixel_ids_a": ids,
            "pixel_ids_b": ids,
            "region_ids_a": ids,
            "region_ids_b": ids,
        }
    return {k: (r.rand(batch, base, base, 3) * 255).astype(np.uint8)
            for k in ("fg", "bg0", "bg1")}


def scan_batches(raw: dict, k: int, r: np.random.RandomState) -> list:
    """``BENCH_SCAN``'s K distinct batches (``bench.py``'s ``stack_k``, keys
    in the sorted order ``tree_map`` visits them): uint8 frames shifted by
    draws in [0, 7), floats moved by 1e-3 draws, id maps kept."""
    stacked = {}
    for name in sorted(raw):
        out = np.stack([raw[name]] * k)
        if out.dtype == np.uint8:
            out = ((out.astype(np.int32) + r.randint(0, 7, out.shape)) % 256).astype(np.uint8)
        elif np.issubdtype(out.dtype, np.floating):
            out = (out + r.rand(*out.shape).astype(out.dtype) * 1e-3).astype(out.dtype)
        stacked[name] = out
    return [{name: v[i] for name, v in stacked.items()} for i in range(k)]


def build(model_cfg: dict, device, *, no_aug: bool, hw: int, metrics_level: int = 0,
          epoch_scalars: bool = False):
    """(state, step) of ``bench.py``'s configuration on ``device``; ``step``
    counts its calls."""
    return bench_pretrain_variant.state_and_step(
        model_cfg, device, "CP2", "DEEPLABV3", hw, metrics_level=metrics_level,
        epoch_scalars=epoch_scalars, augment=not no_aug)


def _loaders(files, batch: int, base: int, threads: int, raw_cache: bool, data_dir: str):
    """Three streams from the loader the pretrain CLI would choose here:
    ``(loaders, "native" | "python")``; ``None`` loaders for a raw-cache
    phase without the native pool."""
    from cp2_tpu_torch.native import NativePretrainLoader, default_cache_path, native_available

    if native_available():
        cache = default_cache_path(data_dir, files, (base, base), "none") if raw_cache else None
        return [NativePretrainLoader(files, batch, (base, base), threads=threads, seed=s,
                                     cache_path=cache) for s in (0, 1, 2)], "native"
    if raw_cache:
        return None, "python"
    from cp2_tpu_torch.data.host_loader import HostDataLoader, PretrainDataSource

    return [HostDataLoader(PretrainDataSource(files, (base, base)), batch, shuffle=True,
                           drop_last=True, seed=s, num_workers=threads)
            for s in (0, 1, 2)], "python"


def e2e_ips(step, state, batch: int, base: int, device, *, steps: int, repeats: int,
            data_root: str, raw_cache: bool = False):
    """The step fed from three loader streams of JPEGs through
    ``DevicePrefetcher`` (depth 2, as the pretrain CLI runs it).  Times
    ``repeats`` segments of ``steps`` steps; returns ``(median images/s,
    detail, loader)``, with ``None`` for a raw-cache phase without the
    native pool."""
    from PIL import Image

    from cp2_tpu_torch.data.prefetch import DevicePrefetcher, HostToDevice

    data_dir = os.path.join(data_root, f"cp2_bench_jpegs_{base}")
    n_images = max(batch * 4, 64)
    files = [os.path.join(data_dir, f"{i:04d}.jpg") for i in range(n_images)]
    if not all(os.path.exists(f) for f in files):
        os.makedirs(data_dir, exist_ok=True)
        r = np.random.RandomState(7)
        for f in files:
            Image.fromarray((r.rand(base, base, 3) * 255).astype(np.uint8)).save(f, quality=90)
    loaders, kind = _loaders(files, batch, base, max(os.cpu_count() or 1, 1), raw_cache,
                             data_dir)
    if loaders is None:
        return None, None, kind

    def epoch_stream():
        epoch = 0
        while True:
            for fg, b0, b1 in zip(*(ld.epoch_iterator(epoch) for ld in loaders)):
                yield {"fg": fg["image"], "bg0": b0["image"], "bg1": b1["image"]}
            epoch += 1

    def one():
        return step(state, next(stream).wait(), E2E_SEED)[1]["loss"]

    stream = DevicePrefetcher(epoch_stream(), HostToDevice(device), depth=2)
    try:
        # with the raw cache, drain epoch 0 so that its one-time build
        # finishes before the timed steps
        for _ in range(-(-n_images // batch) if raw_cache else 1):
            loss = one()
        loss.item()
        seg_secs, seg_ips = [], []
        for _ in range(max(repeats, 1)):
            dt = bm.seconds(one, steps, device)
            seg_secs.append(round(dt, 3))
            seg_ips.append(round(batch * steps / dt, 2))
    finally:
        stream.close()
    detail = {
        "steps_per_segment": steps,
        "segments": len(seg_ips),
        "ips_segments": seg_ips,
        "seconds_segments": seg_secs,
        "ips_spread": round(max(seg_ips) - min(seg_ips), 2),
    }
    return sorted(seg_ips)[len(seg_ips) // 2], detail, kind


def run(model_cfg: dict, device, *, batch: int = 32, hw: int = 224, steps: int = 30,
        warmup: int = 5, no_aug: bool = False, metrics_level: int = 0,
        epoch_scalars: bool = False, scan: int = 1, e2e: bool = True, e2e_steps: int = 20,
        e2e_repeats: int = 3, deadline_s: float = 420.0, data_root: str | None = None,
        t_start: float | None = None) -> dict:
    """The benchmark on ``device``; returns the JSON line's dict."""
    from cp2_tpu_torch.ops import dense_loss
    from cp2_tpu_torch.utils.flops import mfu, peak_bf16_flops

    t_start = time.perf_counter() if t_start is None else t_start
    device = resolve_device(device)
    data_root = data_root or os.path.join(bm.ROOT, "work_dirs")
    bm.reset_peak(device)
    dense_loss.reset_launch_counts()
    t0 = time.perf_counter()
    state, step = build(model_cfg, device, no_aug=no_aug, hw=hw, metrics_level=metrics_level,
                        epoch_scalars=epoch_scalars)
    r = np.random.RandomState(0)
    raw = raw_frames(batch, hw, no_aug, r)
    host_batches = scan_batches(raw, scan, r) if scan > 1 else [raw]
    batches = [{k: torch.from_numpy(v).to(device) for k, v in b.items()}
               for b in host_batches]
    print(f"bench: state and batches built in {time.perf_counter() - t0:.1f}s",
          file=sys.stderr)

    def call():
        # one "call": a step on each of the BENCH_SCAN batches in turn
        for b in batches:
            _, metrics = step(state, b, STEP_SEED)
        return metrics["loss"]

    # the first step, counted: what XLA's cost_analysis gives bench.py
    flops_per_step, dt, final_loss = bm.count_and_time(
        call, warmup=warmup, steps=steps, device=device,
        first=lambda: step(state, batches[0], STEP_SEED))
    if final_loss != final_loss:
        raise RuntimeError("NaN loss in benchmark")

    ips = batch * steps * scan / dt
    peak = peak_bf16_flops(bm.device_name(device))
    share = mfu(flops_per_step, steps * scan, dt, peak)

    e2e_rate = e2e_cached = e2e_detail = e2e_cached_detail = None
    loader = None
    past_deadline = time.perf_counter() - t_start > deadline_s
    if past_deadline:
        print(f"bench: skipping e2e phases ({time.perf_counter() - t_start:.0f}s elapsed > "
              f"BENCH_DEADLINE_S={deadline_s:.0f})", file=sys.stderr)
    if not no_aug and not past_deadline and scan == 1 and e2e:
        e2e_rate, e2e_detail, loader = e2e_ips(
            step, state, batch, hw + 32, device, steps=e2e_steps, repeats=e2e_repeats,
            data_root=data_root)
        if time.perf_counter() - t_start > deadline_s:
            print("bench: skipping raw-cache e2e phase "
                  f"({time.perf_counter() - t_start:.0f}s elapsed > "
                  f"BENCH_DEADLINE_S={deadline_s:.0f})", file=sys.stderr)
        else:
            e2e_cached, e2e_cached_detail, _ = e2e_ips(
                step, state, batch, hw + 32, device, steps=e2e_steps, repeats=e2e_repeats,
                data_root=data_root, raw_cache=True)
    bm.print_launches(step.calls)
    return {
        "metric": "cp2_pretrain_images_per_sec_per_chip",
        "value": round(ips, 2),
        "unit": "images/sec/chip",
        # 330: the JAX package's assumed A100 rate of the reference step,
        # kept for the formula; not a target for this card
        "vs_baseline": round(ips / (TARGET_MULTIPLIER * ASSUMED_REFERENCE_A100_IPS), 3),
        "scope": "device-only",
        "device_ips": round(ips, 2),
        "e2e_ips": e2e_rate,
        "e2e_cached_ips": e2e_cached,
        "e2e_detail": e2e_detail,
        "e2e_cached_detail": e2e_cached_detail,
        "mfu": None if share is None else round(share, 4),
        "model_flops_per_step": flops_per_step,
        "device": bm.card_line(device),
        "loader": loader,
        "peak_device_mib": bm.peak_mib(device),
    }


def main(argv=None) -> int:
    t_start = time.perf_counter()
    if os.environ.get("BENCH_COMPILER_OPTIONS", ""):
        raise SystemExit("BENCH_COMPILER_OPTIONS passes options to XLA's compiler; the "
                         "PyTorch step runs eagerly and has no compiler to pass them to")
    env = os.environ.get
    result = run(
        bm.model_config("config_pretrain.py"), "cuda",
        batch=int(env("BENCH_BATCH", "32")), hw=int(env("BENCH_HW", "224")),
        steps=int(env("BENCH_STEPS", "30")), warmup=int(env("BENCH_WARMUP", "5")),
        no_aug=env("BENCH_NO_AUG", "0") == "1",
        metrics_level=int(env("BENCH_METRICS_LEVEL", "0")),
        epoch_scalars=env("BENCH_EPOCH_SCALARS", "0") == "1",
        scan=int(env("BENCH_SCAN", "1")), e2e=env("BENCH_E2E", "1") == "1",
        e2e_steps=int(env("BENCH_E2E_STEPS", "20")),
        e2e_repeats=int(env("BENCH_E2E_REPEATS", "3")),
        deadline_s=float(env("BENCH_DEADLINE_S", "420")), t_start=t_start)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
