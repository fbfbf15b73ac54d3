"""The traced run: spans around the benchmark's calls into each layer, the
profiler over the measured window, and what the readers take from its
Chrome trace.

Spans (``record_function``, only while tracing): ``loader_wait`` (blocked
on the next staged batch), ``feed`` (a resident batch's gather),
``augment`` (the augmentation call), ``step`` (the train step),
``sync`` (the loop's reads of the loss and the epoch's sums).

The kernel categories and the busy share (the union of the kernel,
memcpy and memset intervals) are frozen from
``cp2_tpu_torch/tools/profile_step.py``.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
from typing import Dict, List, Optional, Tuple

# kernel name fragment -> category, first match wins (names lower-cased)
CATEGORIES = (
    ("dense loss", ("::fwd_kernel<", "::bwd_kernel<")),
    ("convolution", ("conv", "dgrad", "wgrad", "fprop", "implicit_gemm")),
    ("matrix product", ("gemm", "cutlass", "cublas", "matmul")),
    ("batch norm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw", "welford")),
    ("reduction", ("reduce",)),
    ("layout and copy", ("copy", "transpose", "nchw", "nhwc", "cat_", "index", "gather",
                         "scatter", "memcpy", "memset")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)
SPANS = ("loader_wait", "feed", "augment", "step", "sync")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def category(name: str) -> str:
    low = name.lower()
    for label, fragments in CATEGORIES:
        if any(f in low for f in fragments):
            return label
    return "other"


class Spans:
    """``span(name)``: a ``record_function`` while tracing, else nothing."""

    def __init__(self, on: bool):
        self.on = on

    def __call__(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)


@contextlib.contextmanager
def profiled(on: bool, out_path: str):
    """Profile the block (CPU and CUDA) when ``on``; the trace is written
    to ``out_path``."""
    if not on:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield
    prof.export_chrome_trace(out_path)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class Reading:
    """What one traced window shows: device intervals, kernels by name and
    category, the spans and the kernels each launched."""

    def __init__(self, path: str, steps: int, window_s: float, counts: dict,
                 peak: Optional[dict], images: int = 0):
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
        self.steps, self.window_s, self.counts, self.peak = steps, window_s, counts, peak
        self.images = images
        self.kernels = [e for e in events if e.get("cat") in DEVICE_CATS]
        self.spans: Dict[str, List[Tuple[float, float]]] = {n: [] for n in SPANS}
        for e in events:
            if e.get("cat") == "user_annotation" and e.get("name") in self.spans:
                self.spans[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
        for v in self.spans.values():
            v.sort()
        self.launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                          if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
        cpu = [e for e in events if e.get("cat") not in DEVICE_CATS]
        self.t0 = min(e["ts"] for e in cpu) if cpu else 0.0
        self.t1 = max(e["ts"] + e["dur"] for e in cpu) if cpu else 0.0
        self.busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in self.kernels])

    # -- device time ---------------------------------------------------------
    def busy_s(self) -> float:
        return sum(min(e, self.t1) - max(s, self.t0) for s, e in self.busy
                   if e > self.t0 and s < self.t1) / 1e6

    def category_s(self, label: str) -> float:
        return sum(e["dur"] for e in self.kernels if category(e["name"]) == label) / 1e6

    def _inside(self, name: str, ts: float) -> bool:
        spans = self.spans[name]
        i = bisect.bisect_right(spans, (ts, float("inf"))) - 1
        return i >= 0 and spans[i][0] <= ts <= spans[i][1]

    def span_device_s(self, name: str) -> float:
        """Device seconds of the kernels launched inside spans of ``name``."""
        total = 0.0
        for e in self.kernels:
            ts = self.launch_ts.get(e.get("args", {}).get("correlation"))
            if ts is not None and self._inside(name, ts):
                total += e["dur"]
        return total / 1e6

    def span_host_s(self, name: str) -> float:
        return sum(e - s for s, e in self.spans[name]) / 1e6

    # -- breakdown -----------------------------------------------------------
    def device_ops(self, top: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for e in self.kernels:
            by[e["name"]] = by.get(e["name"], 0.0) + e["dur"]
        return [[k[:120], v / 1e6] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def host_at(self, ts: float) -> str:
        """The innermost span the host was in at ``ts``."""
        best: Optional[Tuple[float, str]] = None
        for name in SPANS:
            spans = self.spans[name]
            i = bisect.bisect_right(spans, (ts, float("inf"))) - 1
            if i >= 0 and spans[i][0] <= ts <= spans[i][1]:
                width = spans[i][1] - spans[i][0]
                if best is None or width < best[0]:
                    best = (width, name)
        return best[1] if best else "other"

    def idle_gaps(self, top: int = 10) -> List[list]:
        """Idle device seconds inside the window, summed by what the host
        was doing when each gap began."""
        edges = [(self.t0, self.t0)] + [iv for iv in self.busy
                                         if iv[1] > self.t0 and iv[0] < self.t1]
        edges.append((self.t1, self.t1))
        by: Dict[str, float] = {}
        for (_, end), (start, _) in zip(edges, edges[1:]):
            if start > end:
                name = self.host_at(end)
                by[name] = by.get(name, 0.0) + (start - end) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def read(path: str, steps: int, window_s: float, counts: dict,
         peak: Optional[dict], images: int = 0) -> Reading:
    """The reading of the trace at ``path``, which is then deleted."""
    try:
        return Reading(path, steps, window_s, counts, peak, images)
    finally:
        os.unlink(path)
