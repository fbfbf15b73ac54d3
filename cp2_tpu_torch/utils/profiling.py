"""Tracing, step timing, device memory and numerical-debug utilities.

Port of ``cp2_tpu/utils/profiling.py`` (the reference's observability is
Lightning's ``profiler="simple"`` behind --use_profiler, wall-clock meters
and cudnn determinism toggles):

* ``trace`` — a ``torch.profiler`` context writing a Chrome trace
  (``trace.json``, loadable in Perfetto or ``chrome://tracing``) of the
  host and, where there is a card, its kernels.
* ``span(name)`` — a named host span (``record_function``) while a
  profiler records, a shared no-op context otherwise.  Any profiler sees
  them: ``trace``, ``tools/profile_step.py``, the benchmark's traced run.
  The program's spans:

  - ``pretrain.step`` (``ssl/train_step.py``), holding in order
    ``augment.pretrain``, ``pretrain.ema``, ``pretrain.key_forward``,
    ``pretrain.objective``, ``pretrain.backward``, ``pretrain.grad_reduce``,
    ``pretrain.optimizer``, ``pretrain.enqueue``, ``pretrain.metrics``
    (DenseCL's symmetric loss takes ``ema`` and ``key_forward`` twice);
  - ``finetune.step`` (``train/segmentation_task.py``'s train step),
    holding ``finetune.forward``, ``finetune.backward``,
    ``finetune.grad_reduce``, ``finetune.optimizer``,
    ``finetune.confusion``;
  - ``augment.pretrain`` and ``augment.finetune`` (``augment/pipeline.py``);
  - ``data.wait`` (``data/prefetch.py``): the consumer blocked on the next
    prefetched item;
  - ``model.tap_split`` (``models/layers.py``): the forward, and apart the
    backward, of each convolution that ``conv2d`` runs as the sum of its
    in-bounds taps (the ASPP's d = 12 and d = 18 at 14x14 and 22x22).
* ``StepTimer`` — wall-clock step statistics with p50/p90; ``stop(probe)``
  first synchronises the probe tensor's device, as the JAX timer blocks on
  its probe, so ``--use_profiler`` times a loop held in lockstep with the
  card.
* ``device_memory_summary`` — live / peak / limit bytes of each card from
  ``torch.cuda.memory_stats``, under the JAX keys; ``{}`` with no card.
* ``find_nonfinite`` / ``assert_finite`` — NaN/Inf guards over a state
  dict or any nest of dicts, lists and tensors; integer leaves are
  ignored, as the JAX sweep ignores them.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

TRACE_NAME = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block: ``with trace('/tmp/trace'): step()``
    writes ``log_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_NAME))


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """``with span("pretrain.step"): ...`` records a host span named
    ``name`` while a ``torch.profiler`` records; otherwise it is one shared
    ``nullcontext`` (well under a microsecond, where an idle
    ``record_function`` costs over ten)."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


class StepTimer:
    def __init__(self):
        self.samples: List[float] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, probe: Optional[torch.Tensor] = None) -> None:
        """Close the sample; a CUDA ``probe`` first synchronizes its card.
        That sync comes on every step, so the samples time a loop in
        lockstep with the card, not the loop that queues steps ahead."""
        if probe is not None and probe.is_cuda:
            torch.cuda.synchronize(probe.device)
        self.samples.append(time.perf_counter() - self._t0)

    def summary(self) -> Dict[str, float]:
        if not self.samples:
            return {}
        arr = np.asarray(self.samples)
        return {
            "steps": len(arr),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p90_s": float(np.percentile(arr, 90)),
            "max_s": float(arr.max()),
        }


def device_memory_summary() -> Dict[str, Any]:
    """``{"cuda:i": {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}}``."""
    out: Dict[str, Any] = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out


def _leaves(tree: Any, path: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}" if path else str(i))
    else:
        yield path, tree


def find_nonfinite(tree: Any, prefix: str = "") -> List[str]:
    """Paths (``/``-joined keys) of the float leaves holding NaN or Inf."""
    bad = []
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
                bad.append(prefix + path)
        elif isinstance(leaf, (np.ndarray, np.floating)):
            if np.issubdtype(leaf.dtype, np.floating) and not np.isfinite(leaf).all():
                bad.append(prefix + path)
    return bad


def assert_finite(tree: Any, what: str = "state") -> None:
    bad = find_nonfinite(tree)
    if bad:
        raise FloatingPointError(f"non-finite values in {what}: {bad[:10]}")
