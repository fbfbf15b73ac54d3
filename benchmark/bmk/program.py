"""What the program's own spans show in a traced run: host dispatch,
kernels and host syncs per train step, read from a ``trace.Reading``.

The program's spans are the ``user_annotation`` events of the trace
whose names are dotted lower-case words (``PROGRAM_SPAN``), which leaves
out the benchmark's own (``trace.SPANS``, no dot) and PyTorch's
(``Optimizer.step#SGD.step``); their names are read from the trace, not
from a list.  The program (``cp2_tpu_torch/utils/profiling.py::span``)
names its train steps by phase (``pretrain.step``, ``finetune.step``: any
span named ``*.step``), its augmentations (``augment.*``), the
prefetcher's wait (``data.wait``) and its model's parts (``model.*``).
The step-level window is the union of the host intervals of the
``*.step`` and ``augment.*`` spans (``augment.pretrain`` runs inside
``pretrain.step``).  Step ``i`` is what
the window holds after step ``i - 1``'s step span ended, up to the end of
its own: a finetune step's augmentation goes with the step that follows.

Events are put in the window by their host time, on any thread: the
backward's launches come from the autograd engine's thread while the
main thread waits in ``pretrain.backward``.  A kernel counts where its
launch (``Reading.launch_ts``) lies; a sync call where it starts.

A trace without step spans (a program that has none) reads ``None``.
The first reading of a run also prints, to standard error, the idle
device ms per step by the innermost program span the host was in when
each gap began (``trace.Reading.host_at``'s rule).
"""

from __future__ import annotations

import bisect
import fnmatch
import re
import statistics
import sys
from collections import Counter
from typing import Dict, List, Optional, Tuple

from bmk import trace

PROGRAM_SPAN = re.compile(r"[a-z0-9_]+(\.[a-z0-9_]+)+")
STEP_SPANS = "*.step"
AUGMENT_SPANS = "augment.*"
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
         "cudaMemcpy", "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize")


class Steps:
    """The program's steps in one reading: the window, and per step the
    kernels launched and the sync calls made inside it."""

    def __init__(self, r: "trace.Reading"):
        self.spans: Dict[str, List[Tuple[float, float]]] = {
            n: v for n, v in r.spans.items() if PROGRAM_SPAN.fullmatch(n)}
        syncs = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in r.calls
                 if e.get("name") in SYNCS]
        self.ends = sorted(e for _, e in self._matching(STEP_SPANS))
        self.window = trace._union(self._matching(STEP_SPANS) + self._matching(AUGMENT_SPANS))
        self._starts = [s for s, _ in self.window]
        n = len(self.ends)
        self.kernels, self.syncs = [0] * n, [0] * n
        for e in r.kernels:
            ts = r.launch_ts.get(e.get("args", {}).get("correlation"))
            if e.get("cat") == "kernel" and ts is not None:
                self._count(self.kernels, ts)
        held, self.sync_names = [], Counter()
        for s, e, name in syncs:
            w = self._in_window(s)
            if w is not None and self._count(self.syncs, s):
                held.append((s, min(e, w[1])))
                self.sync_names[name] += 1
        self.sync_s = sum(e - s for s, e in trace._union(held)) / 1e6
        self.window_s = sum(e - s for s, e in self.window) / 1e6

    def _matching(self, pattern: str) -> List[Tuple[float, float]]:
        return [iv for n, v in self.spans.items() if fnmatch.fnmatchcase(n, pattern)
                for iv in v]

    def _in_window(self, ts: float) -> Optional[Tuple[float, float]]:
        i = bisect.bisect_right(self._starts, ts) - 1
        if i >= 0 and ts <= self.window[i][1]:
            return self.window[i]
        return None

    def _count(self, per_step: List[int], ts: float) -> bool:
        """Add an event at ``ts`` to its step, if it lies in the window."""
        i = bisect.bisect_left(self.ends, ts)
        if i == len(self.ends) or self._in_window(ts) is None:
            return False
        per_step[i] += 1
        return True

    def idle_ms_per_step(self, r: "trace.Reading", steps: int) -> Dict[str, float]:
        """Idle device ms per step, by the innermost program span the host
        was in when each gap began (``other`` outside them all)."""
        edges = [(r.t0, r.t0)] + [iv for iv in r.busy if iv[1] > r.t0 and iv[0] < r.t1]
        edges.append((r.t1, r.t1))
        by: Dict[str, float] = {}
        for (_, end), (start, _) in zip(edges, edges[1:]):
            if start > end:
                name = self._host_at(end)
                by[name] = by.get(name, 0.0) + (start - end) / 1e3 / steps
        return dict(sorted(by.items(), key=lambda kv: -kv[1]))

    def _host_at(self, ts: float) -> str:
        best: Optional[Tuple[float, str]] = None
        for name, spans in self.spans.items():
            i = bisect.bisect_right(spans, (ts, float("inf"))) - 1
            if i >= 0 and spans[i][0] <= ts <= spans[i][1]:
                width = spans[i][1] - spans[i][0]
                if best is None or width < best[0]:
                    best = (width, name)
        return best[1] if best else "other"


def steps_of(r) -> Optional[Steps]:
    """The reading's ``Steps``, made once (and the idle line printed), or
    ``None`` without the program's step spans."""
    if "_program_steps" not in r.__dict__:
        s = Steps(r)
        r._program_steps = s if s.ends else None
        if s.ends and r.steps:
            idle = s.idle_ms_per_step(r, r.steps)
            print("program idle ms/step by span: " + ", ".join(
                f"{k} {v:.3f}" for k, v in idle.items()), file=sys.stderr)
            print(f"program steps: {len(s.ends)} spans, {r.steps} counted; kernels "
                  f"{sum(s.kernels)} ({sum(s.kernels) / r.steps:.2f}/step, by step "
                  f"{_tally(s.kernels)}); syncs {sum(s.syncs)} (by step {_tally(s.syncs)}, "
                  f"{s.sync_s / r.steps * 1e3:.3f} ms/step, {dict(s.sync_names)}); "
                  f"augment device ms/step "
                  f"{r.device_s(spans=(AUGMENT_SPANS,)) / r.steps * 1e3:.4f}",
                  file=sys.stderr)
    return r._program_steps


def _tally(per_step: List[int]) -> str:
    return " ".join(f"{k}x{n}" for k, n in sorted(Counter(per_step).items()))


def dispatch_ms(r) -> Optional[float]:
    """Host ms per step inside the step-level window, less the host time
    inside the sync calls there."""
    s = steps_of(r)
    if s is None or not r.steps:
        return None
    return (s.window_s - s.sync_s) / r.steps * 1e3


def kernels_per_step(r) -> Optional[float]:
    """Kernels one step launches: the median over the window's steps (a
    pretrain epoch's first step also computes the logged scalars)."""
    s = steps_of(r)
    return float(statistics.median(s.kernels)) if s is not None else None


def host_syncs_per_step(r) -> Optional[float]:
    """Sync calls one step makes: the median over the window's steps."""
    s = steps_of(r)
    return float(statistics.median(s.syncs)) if s is not None else None
