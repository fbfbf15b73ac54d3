"""One run of one cell: set-up, the measured window, the check, the line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in ``setup_s``, from the process's start): the corpus
(written once per checkout), the feed, the program's model, optimizer and
steps, and the first epoch, whose first steps the check reads.  The window
then runs whole training steps until ``--seconds`` have passed and ends in
a device synchronize; with ``--trace 1`` its last ``TRACED_S`` seconds
run under the profiler, with the benchmark's spans, after a device
synchronize, and the per-layer metrics are read from their trace.
After the window the peak memory is read, the program's state is freed,
and the reference repeats the checked steps in float32 with TF32 off.

The last line on standard output is one JSON object: ``correct``,
``attempted`` (steps in the whole window), ``failed``, ``metrics``, ``device``,
with ``--trace 1`` a ``breakdown``, and last ``checks``, each compared
number beside its limit; the same numbers close standard error.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import sys
import time

from bmk import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "cp2_tpu")
EXIT_USAGE, EXIT_NO_CARD, EXIT_FORBIDDEN = 2, 3, 4
# A traced run profiles the last 30 s of its window: the pretrain's 51 s
# trace holds 7 M events, and writing and reading them took a traced run
# past the 360 s a run may take.
TRACED_S = 30.0


def cache_env(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    base = os.path.join(root, ".bench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_ext"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(base, sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules():
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


@contextlib.contextmanager
def no_tf32():
    import torch

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def synchronize(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def device_name(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def host_line() -> str:
    """The host's CPUs as this process sees them, and its load, for the
    look at runs that spread: the cores, those this process may use, the
    load averages, the process's threads and torch's intra-op threads."""
    import threading

    import torch

    usable = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else -1
    load = " ".join(f"{v:.2f}" for v in os.getloadavg())
    return (f"{os.cpu_count()} cpus, {usable} usable, load {load}, "
            f"{threading.active_count()} threads, torch {torch.get_num_threads()}")


def build(cell):
    """The corpus and the program's runner of the cell's task."""
    from bmk import corpus, trace

    t0 = time.perf_counter()
    pairs = corpus.ensure(cell.scratch, cell.traffic["corpus"])
    t1 = time.perf_counter()
    runner = spec.task(cell.config["task"]).Runner(cell, trace.Spans(cell.trace), pairs)
    print(f"setup: corpus {t1 - t0:.2f} s, feed and program {time.perf_counter() - t1:.2f} s",
          file=sys.stderr)
    return runner


def check(runner, limits):
    """Free the program, run the reference, compare: (correct, checks);
    every number that could be compared goes to standard error."""
    import torch

    from bmk import checks
    from reference import nets

    runner.free()
    gc.collect()
    if runner.device.type == "cuda":
        torch.cuda.empty_cache()
    with no_tf32():
        ref = runner.reference_side(nets.FP32)
    values = checks.readings(runner.program_side(), ref)
    print("readings " + json.dumps(values), file=sys.stderr)
    return checks.verdict(values, limits)


def run_cell(cell, t_start: float) -> dict:
    import torch

    from bmk import counts, trace

    runner = build(cell)
    device = runner.device
    t0 = time.perf_counter()
    runner.setup()
    synchronize(device)
    print(f"setup: first epoch {time.perf_counter() - t0:.2f} s", file=sys.stderr)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start

    os.makedirs(cell.scratch, exist_ok=True)
    path = os.path.join(cell.scratch, f"trace_{cell.name}.json")
    seconds, lead = cell.seconds, 0
    if cell.trace and seconds > TRACED_S:
        lead = runner.window(seconds - TRACED_S)
        synchronize(device)
        seconds = TRACED_S
    with trace.profiled(cell.trace, path):
        t0 = time.perf_counter()
        steps = runner.window(seconds)
        synchronize(device)
        window_s = time.perf_counter() - t0
    print("window: whole epochs (s) " + " ".join(f"{s:.3f}" for s in runner.epoch_s),
          file=sys.stderr)
    print(f"host: {host_line()}", file=sys.stderr)
    peak_bytes = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    name = device_name(device)
    if device.type == "cuda":
        print(f"card: {card_line()}", file=sys.stderr)
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": name, "count": 1,
           "memory_peak_bytes": int(peak_bytes)}
    result = {"correct": False, "attempted": lead + steps, "failed": 0, "metrics": {},
              "device": dev}
    if cell.trace:
        peak = counts.peaks(name)
        t0 = time.perf_counter()
        reading = trace.read(path, steps, window_s, runner.counts(peak), peak,
                             runner.images(steps))
        dev["busy_s"], dev["window_s"] = reading.busy_s(), window_s
        for m in cell.per_layer():
            value = spec.reader(m["name"], cell.root)(reading)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = {"device_ops": reading.device_ops(),
                               "idle_gaps": reading.idle_gaps()}
        for part in ("spans", "ops"):
            print(f"device s by launching {part}: " + ", ".join(
                f"{k} {v:.4f}" for k, v in reading.device_by(part)), file=sys.stderr)
        print(f"trace: {len(reading.events)} events, {len(reading.kernels)} on the device, "
              f"read in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    else:
        # the cell's one rate in images/s, whatever its name
        known = {"setup_s": setup_s, "peak_mib": peak_bytes / 2**20}
        rate = runner.images(steps) / window_s
        for m in cell.end_to_end():
            value = known.get(m["name"], rate if m["unit"] == "images/s" else None)
            result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    ok, checks = check(runner, cell.config["limits"])
    result["correct"] = ok
    result["checks"] = checks
    return result


def main(argv, t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env(spec.ROOT)
    try:
        cell = spec.Cell.load(args.workload, args.seed, args.seconds, bool(args.trace))
    except (OSError, KeyError, ValueError) as e:
        print(f"benchmark: cannot load the cell: {e}", file=sys.stderr)
        return EXIT_USAGE
    import torch

    need = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"benchmark: the cell needs {need} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return EXIT_NO_CARD
    try:
        import cp2_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"benchmark: the program is not in this checkout: {e}", file=sys.stderr)
        return EXIT_USAGE
    result = run_cell(cell, t_start)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: loaded {', '.join(bad)}, which no run may load", file=sys.stderr)
        return EXIT_FORBIDDEN
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
