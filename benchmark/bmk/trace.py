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

A ``Reading`` keeps the trace's host events (``events``) and puts each
device event (kernel, memcpy, memset) to what launched it
(``Reading.launches``): its launch call, found by ``args.correlation``;
the chain of ``cpu_op`` events enclosing that call on the call's own
thread (``aten::conv2d`` > ``aten::convolution`` > ... on the main
thread, ``ConvolutionBackward0`` > ``aten::convolution_backward`` on the
autograd engine's); and the ``user_annotation`` spans of any name that
enclose the call on any thread, the benchmark's and the program's alike
(the backward's launches come from the autograd engine's thread while the
main thread waits in the program's backward span).  Readers then take
device time by op or by span from patterns (``fnmatch``: ``model.*``,
``aten::*convolution*``), with no list of names to extend.
"""

from __future__ import annotations

import bisect
import contextlib
import fnmatch
import json
import os
from collections import defaultdict
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

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


class Launch(NamedTuple):
    """What launched one device event: the ``cpu_op`` names enclosing its
    launch call on the call's thread and the spans enclosing the call on
    any thread, each outermost first."""

    ops: Tuple[str, ...]
    spans: Tuple[str, ...]


NOT_LAUNCHED = Launch((), ())  # a device event whose launch call the trace lacks


def _chains(cpu_ops: List[dict], annotations: List[dict],
            calls: Dict[int, dict]) -> Dict[int, Launch]:
    """``Launch`` of each launch call of ``calls`` (by correlation id)."""
    ops: Dict[int, Tuple[str, ...]] = {}
    by_thread = defaultdict(list)
    for e in cpu_ops:
        by_thread[(e.get("pid"), e.get("tid"))].append((e["ts"], -e["dur"], 0, e["name"]))
    for c, e in calls.items():
        by_thread[(e.get("pid"), e.get("tid"))].append((e["ts"], -e["dur"], 1, c))
    interned: Dict[tuple, tuple] = {}
    for items in by_thread.values():
        items.sort(key=lambda x: (x[0], x[1], x[2]))
        stack: List[Tuple[float, str]] = []  # (end, name) of the open ops
        for ts, neg_dur, is_call, what in items:
            while stack and stack[-1][0] < ts:
                stack.pop()
            if is_call:
                chain = tuple(name for _, name in stack)
                ops[what] = interned.setdefault(chain, chain)
            else:
                stack.append((ts - neg_dur, what))
    # spans of any thread: a sweep over time, the open spans widest first
    marks = sorted([(e["ts"], 0, e["dur"], e["name"]) for e in annotations]
                   + [(e["ts"], 1, 0.0, c) for c, e in calls.items()],
                   key=lambda x: (x[0], x[1]))
    open_: List[Tuple[float, float, str]] = []  # (width, end, name)
    out: Dict[int, Launch] = {}
    for ts, is_call, dur, what in marks:
        if is_call:
            open_ = [s for s in open_ if s[1] >= ts]
            chain = tuple(name for _, _, name in sorted(open_, key=lambda s: -s[0]))
            out[what] = Launch(ops.get(what, ()), interned.setdefault(chain, chain))
        else:
            open_.append((dur, ts + dur, what))
    return out


def _matcher(patterns: Iterable[str]):
    """Whether any name of a chain matches any pattern, memoized by chain."""
    patterns = tuple(patterns)
    seen: Dict[tuple, bool] = {}

    def match(chain: tuple) -> bool:
        if chain not in seen:
            seen[chain] = any(fnmatch.fnmatchcase(n, p) for n in chain for p in patterns)
        return seen[chain]

    return match


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
    """What one traced window shows: the trace's complete events
    (``events``), device intervals, kernels by name and category, the
    spans, and what launched each kernel (``launches``)."""

    def __init__(self, path: str, steps: int, window_s: float, counts: dict,
                 peak: Optional[dict], images: int = 0):
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
        self.events = events
        self.steps, self.window_s, self.counts, self.peak = steps, window_s, counts, peak
        self.images = images
        by_cat: Dict[Optional[str], List[dict]] = defaultdict(list)
        for e in events:
            by_cat[e.get("cat")].append(e)
        self.kernels = [e for c in DEVICE_CATS for e in by_cat[c]]
        self.calls = [e for c in LAUNCH_CATS for e in by_cat[c]]  # launches, syncs, copies
        self.spans: Dict[str, List[Tuple[float, float]]] = {n: [] for n in SPANS}
        for e in by_cat["user_annotation"]:
            self.spans.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
        for v in self.spans.values():
            v.sort()
        self._by_correlation = {e["args"]["correlation"]: e for e in self.calls
                       if "correlation" in e.get("args", {})}
        self.launch_ts = {c: e["ts"] for c, e in self._by_correlation.items()}
        self._cpu_ops, self._annotations = by_cat["cpu_op"], by_cat["user_annotation"]
        self._launches: Optional[List[Launch]] = None
        host = [e for c, v in by_cat.items() if c not in DEVICE_CATS for e in v]
        self.t0 = min(e["ts"] for e in host) if host else 0.0
        self.t1 = max(e["ts"] + e["dur"] for e in host) if host else 0.0
        self.busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in self.kernels])

    # -- device time ---------------------------------------------------------
    def busy_s(self) -> float:
        return sum(min(e, self.t1) - max(s, self.t0) for s, e in self.busy
                   if e > self.t0 and s < self.t1) / 1e6

    def category_s(self, label: str) -> float:
        return sum(e["dur"] for e in self.kernels if category(e["name"]) == label) / 1e6

    # -- attribution ---------------------------------------------------------
    @property
    def launches(self) -> List[Launch]:
        """``Launch`` of each of ``kernels``, in order, made on first use."""
        if self._launches is None:
            chains = _chains(self._cpu_ops, self._annotations, self._by_correlation)
            self._launches = [chains.get(e.get("args", {}).get("correlation"), NOT_LAUNCHED)
                              for e in self.kernels]
        return self._launches

    def device_s(self, ops: Iterable[str] = (), spans: Iterable[str] = ()) -> float:
        """Device seconds of the kernels, copies and memsets launched inside
        an op whose name matches one of ``ops``, or inside a span whose
        name matches one of ``spans`` (``fnmatch`` patterns); each counts
        once, however many of them enclose its launch."""
        by_op, by_span = _matcher(ops), _matcher(spans)
        return sum(e["dur"] for e, l in zip(self.kernels, self.launches)
                   if by_op(l.ops) or by_span(l.spans)) / 1e6

    def device_by(self, part: str, top: int = 10) -> List[list]:
        """Device seconds by the innermost span (``part="spans"``) or the
        outermost op (``"ops"``) that launched them, most first; ``-``
        where there is none."""
        by: Dict[str, float] = defaultdict(float)
        for e, l in zip(self.kernels, self.launches):
            chain = getattr(l, part)
            by[(chain[-1] if part == "spans" else chain[0]) if chain else "-"] += e["dur"]
        return [[k[:120], v / 1e6] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def span_host_s(self, name: str) -> float:
        """Host seconds inside spans matching ``name``, on any thread; a
        span inside another that matches counts once."""
        hits = [iv for n, v in self.spans.items() if fnmatch.fnmatchcase(n, name) for iv in v]
        return sum(e - s for s, e in _union(hits)) / 1e6

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
