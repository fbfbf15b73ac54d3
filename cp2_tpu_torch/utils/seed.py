"""Determinism helpers.

The reference seeds python/numpy/torch/cuda (main.py:319-335).  The port
seeds the host RNGs and torch's default generators, and returns the base
seed from which each step seeds its own generator
(``ssl.train_step.step_generator``), as the JAX package returns its root
key.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def seed_everything(seed: int) -> int:
    """Seed Python, numpy and torch (every device); return the base seed."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return int(seed)
