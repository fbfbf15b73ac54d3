"""Collectives and the process bootstrap of a run on more than one process.

Twin of ``cp2_tpu/parallel/collectives.py``.  The JAX package runs one
process per host under global-view ``jit``, where these collectives are
implicit; PyTorch runs one process per card (``torchrun``), so each is an
explicit call on the default ``torch.distributed`` process group:

| JAX package                         | here                                  |
|-------------------------------------|---------------------------------------|
| ``initialize()``                    | ``initialize()``: ``torchrun``'s env  |
| ``concat_all_gather``               | ``concat_all_gather``                 |
| ``pmean_gradients`` (XLA's reduce)  | ``pmean_gradients``: one flat buffer  |
| ``psum_metrics``                    | ``psum_metrics``: float and int64     |
|                                     | ``pmean_metrics``: ``psum / W``       |
| ``barrier()``                       | ``barrier()``                         |

Every collective is an ``all_reduce``.  NCCL runs them across cards; gloo
reduces CUDA tensors only in ``all_reduce`` and ``broadcast`` (it has no
``all_gather`` for them), so building everything on ``all_reduce`` lets
the same code run over gloo, e.g. two processes sharing one card, which
NCCL refuses.  With no process group every function is the identity (or
returns at once), so a one-process run is untouched.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Iterable, Optional

import torch
import torch.distributed as dist

# torchrun's environment: any of these marks a launched multi-process run
_LAUNCH_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def is_active() -> bool:
    """Whether a default process group exists in this process."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_active() else 1


def rank() -> int:
    return dist.get_rank() if is_active() else 0


def initialize(backend: Optional[str] = None, *, init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               device=None, timeout: Optional[float] = None) -> bool:
    """Join the default process group; returns whether one is active.

    With no argument and none of ``torchrun``'s variables (``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) set, it
    returns False and touches nothing: a plain one-process run.  Otherwise
    it rendezvouses (``env://`` unless ``init_method`` is given) and
    returns True; a second call returns True at once.  A failed rendezvous
    raises: it never carries on as a single process.  The backend defaults
    to ``nccl`` when ``device`` (default: the card if there is one) is a
    CUDA device and ``gloo`` when it is the CPU; a caller may name it.
    ``timeout`` (seconds) bounds the rendezvous and every collective.
    """
    if is_active():
        return True
    explicit = any(v is not None for v in (init_method, world_size, rank))
    if not explicit and not any(os.environ.get(k) for k in _LAUNCH_ENV):
        return False
    if backend is None:
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    kwargs = {}
    if world_size is not None:
        kwargs["world_size"] = world_size
    if rank is not None:
        kwargs["rank"] = rank
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend, init_method=init_method or "env://", **kwargs)
    return True


def shutdown() -> None:
    """Leave the default process group, if there is one."""
    if is_active():
        dist.destroy_process_group()


def group_device() -> torch.device:
    """The device the default group's collectives run on: the current card
    under NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


@torch.no_grad()
def concat_all_gather(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` stacked along dim 0 in rank order, no gradient
    (reference ``builder.py:1710-1722``).

    One ``all_reduce(SUM)`` of a zero ``(W·B, ...)`` buffer in which each
    rank has filled its own rows: adding zeros is exact.  Every rank must
    hand the same shape.  With one process it is ``x`` itself.
    """
    x = x.detach()
    world = world_size()
    if world == 1:
        return x
    b = x.shape[0]
    out = x.new_zeros((world * b,) + tuple(x.shape[1:]))
    out[rank() * b:(rank() + 1) * b] = x
    dist.all_reduce(out)
    return out


def _reduce_flat(tensors, divide: int = 1) -> None:
    """``all_reduce(SUM)`` a list of tensors in place through one flat
    buffer per (dtype, device), then divide by ``divide``."""
    groups: Dict[tuple, list] = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for members in groups.values():
        flat = torch.cat([t.reshape(-1) for t in members])
        dist.all_reduce(flat)
        if divide != 1:
            flat.div_(divide)
        offset = 0
        for t in members:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


@torch.no_grad()
def pmean_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Average every parameter's gradient over the ranks, in place (DDP's
    all-reduce): one flat buffer, ``all_reduce(SUM)``, then ÷ W.  A no-op
    without a process group; with one it reduces even at W = 1, which
    leaves the values as they are."""
    if not is_active():
        return
    _reduce_flat([p.grad for p in params if p.grad is not None], divide=world_size())


@torch.no_grad()
def psum_metrics(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The sum over ranks of each tensor of ``tensors`` (a dict), as new
    tensors: float scalars and int64 confusion counts alike, one buffer per
    dtype (the torchmetrics ``sync_dist`` equivalent).  Without a process
    group the tensors come back as they are."""
    if not is_active():
        return dict(tensors)
    out = {k: v.detach().clone() for k, v in tensors.items()}
    _reduce_flat(list(out.values()))
    return out


def pmean_metrics(scalars: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each scalar's mean over the ranks (``psum / W``, in float32), one
    all-reduce; the scalars as they are with one process."""
    world = world_size()
    if world == 1:
        return scalars
    return {k: v / world for k, v in psum_metrics(
        {k: v.float() for k, v in scalars.items()}).items()}


def barrier() -> None:
    """Wait for every rank: an ``all_reduce`` of one element on the
    group's device (a no-op without a process group)."""
    if is_active():
        dist.all_reduce(torch.zeros(1, device=group_device()))


@torch.no_grad()
def check_replicas(tensors: Iterable[torch.Tensor], what: str = "weights") -> None:
    """Raise unless every rank holds the same ``tensors``: one float64
    checksum per rank, reduced by MAX as (c, -c) so every rank learns the
    largest and the smallest and all raise together."""
    if world_size() == 1:
        return
    c = sum((t.detach().double().sum().cpu() for t in tensors), torch.zeros((), dtype=torch.float64))
    both = torch.stack([c, -c]).to(group_device())
    dist.all_reduce(both, op=dist.ReduceOp.MAX)
    high, low = float(both[0]), -float(both[1])
    if high != low:
        raise RuntimeError(f"ranks hold different {what}: checksums span [{low!r}, {high!r}]")
