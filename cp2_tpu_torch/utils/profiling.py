"""Step timing for ``--use_profiler``.

Port of ``StepTimer`` of ``cp2_tpu/utils/profiling.py`` (the reference's
Lightning ``profiler="simple"``): wall-clock step statistics with p50/p90.
The card runs asynchronously, so ``stop(probe)`` first synchronises the
probe tensor's device, as the JAX timer blocks on its probe.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch


class StepTimer:
    def __init__(self):
        self.samples: List[float] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, probe: Optional[torch.Tensor] = None) -> None:
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
