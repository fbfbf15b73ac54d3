"""Negative-queue ops.

Port of ``cp2_tpu/ssl/queue.py``.  The JAX queue is a pure scatter on
explicit state; here ``queue_enqueue`` writes the (K, C) queue in place
(one ``index_copy_``, no new 32 MB tensor per step) and returns the new
pointer, a host integer, so the step never waits on the device for it.
"""

from __future__ import annotations

import torch


def queue_enqueue(queue: torch.Tensor, ptr: int, keys: torch.Tensor) -> int:
    """Insert ``keys`` (B, C) at ``ptr`` with wraparound; returns the new ptr.

    B > K is rejected like the reference's assert (builder.py:578).
    """
    k, batch = queue.shape[0], keys.shape[0]
    if batch > k:
        raise ValueError(
            f"enqueue batch {batch} exceeds queue length {k}; shrink the "
            "batch or grow the queue (reference asserts the same, "
            "builder.py:578)"
        )
    idx = (torch.arange(batch, device=queue.device) + ptr) % k
    queue.index_copy_(0, idx, keys.detach().to(queue.dtype))
    return (ptr + batch) % k


def init_queue(generator: torch.Generator, queue_len: int, dim: int) -> torch.Tensor:
    """Random unit-normalized (K, dim) queue (reference builder.py:476-482)."""
    q = torch.randn(queue_len, dim, generator=generator, dtype=torch.float32)
    return q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
