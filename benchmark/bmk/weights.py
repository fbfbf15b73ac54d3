"""Weights and queues made from the run's seed, on the device, in a few
large calls: one normal draw for every convolution kernel (scaled by
1/sqrt(fan-in), LeCun's normal), ones for BatchNorm scales and running
variances, zeros for shifts, biases and running means, and the
configuration's ``init.branch_bn_scale`` for each residual branch's last
BatchNorm scale.  The program and
the reference are handed the same tensors, under the program's
``state_dict`` names."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

WEIGHTS_STREAM, QUEUE_STREAM = 1, 2


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream * 7_919) % (1 << 63))
    return g


def make(spec: List[Tuple[str, tuple, str]], seed: int, device,
         branch_scale: float) -> Dict[str, torch.Tensor]:
    convs = [(n, s) for n, s, kind in spec if kind == "conv"]
    total = sum(math.prod(s) for _, s in convs)
    flat = torch.randn(total, generator=generator(seed, WEIGHTS_STREAM, device), device=device)
    out, at = {}, 0
    for name, shape in convs:
        size = math.prod(shape)
        fan_in = size // shape[0]
        out[name] = flat[at:at + size].view(shape) * (1.0 / math.sqrt(fan_in))
        at += size
    for name, shape, kind in spec:
        if kind == "ones":
            out[name] = torch.ones(shape, device=device)
        elif kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "branch":
            out[name] = torch.full(shape, float(branch_scale), device=device)
    return {name: out[name] for name, _, _ in spec}


def queue(length: int, dim: int, seed: int, device) -> torch.Tensor:
    """(length, dim) random unit rows."""
    q = torch.randn(length, dim, generator=generator(seed, QUEUE_STREAM, device), device=device)
    return q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
