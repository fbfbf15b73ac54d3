"""What the measuring tools share: the device, its clock, its memory, the
card's name and power limit, the configs, and the dense-loss launch line.

Each tool keeps the body of its work in a function that takes the model
config and the device; its ``main()`` calls it with the JAX tool's
config and ``"cuda"`` (``parallel.resolve_device``: no card, no run), and the CPU tests
call it with a narrow config and ``"cpu"``.
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Callable, Optional

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
LAUNCH_TAG = "LAUNCHES"


def model_config(name: str) -> dict:
    """``model`` of ``cp2_tpu_torch/configs/<name>``, a fresh dict."""
    import cp2_tpu_torch
    from cp2_tpu_torch.config import Config

    cfg = Config.fromfile(os.path.join(os.path.dirname(cp2_tpu_torch.__file__),
                                       "configs", name))
    return dict(cfg.model)


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    ``"cpu"``."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True)
    return out.stdout.strip().splitlines()[device.index or 0]


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        # the caching allocator knows no device until CUDA has started, and
        # a tool's first call on the card may be this one
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)


def peak_mib(device: torch.device) -> Optional[float]:
    """Peak allocated device memory since ``reset_peak``, MiB; ``None`` on
    the CPU."""
    if device.type != "cuda":
        return None
    return round(torch.cuda.max_memory_allocated(device) / 2**20, 1)


def seconds(fn: Callable[[], object], steps: int, device: torch.device) -> float:
    """Host-clock seconds of ``steps`` calls of ``fn``, ending in a device
    synchronize."""
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    synchronize(device)
    return time.perf_counter() - t0


class Counted:
    """``fn`` that counts its calls in ``calls``: a tool wraps its step in
    it, so that the steps it reports are those that ran."""

    def __init__(self, fn: Callable):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.fn(*args, **kwargs)


def print_launches(steps: int) -> None:
    """Print ``LAUNCHES {...}``: the dense-loss kernels' launches in this
    process since the tool reset them, beside the steps it ran (a CP2 step
    launches each kernel once)."""
    from cp2_tpu_torch.ops import dense_loss

    print(f"{LAUNCH_TAG} {json.dumps({'steps': steps, **dense_loss.LAUNCHES})}", flush=True)


def count_and_time(call: Callable[[], torch.Tensor], *, warmup: int, steps: int,
                   device: torch.device, first: Optional[Callable[[], object]] = None):
    """One counted call of ``first`` (default: ``call``; its FLOPs, as
    ``utils/flops.py`` counts them), then ``warmup`` calls, then ``steps``
    timed ones; ``call`` returns the step's loss.  Returns ``(flops,
    seconds of the timed calls, final loss)``."""
    from cp2_tpu_torch.utils.flops import flop_counter

    with flop_counter() as counter:
        (first or call)()
    for _ in range(warmup):
        call()
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = call()
    final = loss.item()
    synchronize(device)
    return counter.get_total_flops(), time.perf_counter() - t0, final


def to_meta(tree):
    """Every tensor of a nest of named tuples, tuples, lists and dicts
    moved to the meta device (a step counted from its shapes alone)."""
    if isinstance(tree, torch.Tensor):
        return tree.to("meta")
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_meta(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_meta(v) for v in tree)
    if isinstance(tree, dict):
        return {k: to_meta(v) for k, v in tree.items()}
    return tree
