"""The process layout of a data-parallel run, and the CLIs' start-up.

Twin of ``cp2_tpu/parallel/mesh.py``.  PyTorch has no device mesh here:
there is one process per card (``torchrun --nproc_per_node N``), and a
``Layout`` says which process this is.  The batch is split by rows: the
global batch is the concatenation of the ranks' local batches in rank
order, as ``shard_batch`` assembles it in the JAX package.  Three things
that global-view ``jit`` gives the JAX package for free are explicit in
the port:

* BatchNorm statistics over the global batch (``models/layers.py``);
* every rank enqueues the global batch's keys (``concat_all_gather``);
* metrics over the global batch (``psum_metrics``).

Random draws of a batch (augmentation parameters, dropout masks) are made
for the global batch from the same ``(seed, step)`` generator on every
rank, and each rank keeps its rows (``Layout.rows``, ``take_rows``), as
JAX's sharding-invariant keys make every shard draw what one device
would.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass, field
from typing import Any, Iterator, Tuple

import torch

from cp2_tpu_torch.parallel import collectives


@dataclass(frozen=True)
class Layout:
    """This process's place in the run: ``rank`` of ``world`` processes,
    ``local_rank`` on its host, and its ``device``."""

    rank: int = 0
    world: int = 1
    local_rank: int = 0
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))

    @property
    def shard(self) -> Tuple[int, int]:
        """``(rank, world)``: the loaders' ``shard`` argument."""
        return (self.rank, self.world)

    @property
    def is_main(self) -> bool:
        """Rank 0 writes the logs, metrics, visuals and checkpoints."""
        return self.rank == 0

    def local_batch(self, global_batch: int) -> int:
        """This rank's rows of a global batch (the JAX CLIs' check)."""
        if global_batch % self.world:
            raise ValueError(
                f"batch_size {global_batch} not divisible by {self.world} processes")
        return global_batch // self.world

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``x``, drawn for the global batch."""
        if self.world == 1:
            return x
        n = self.local_batch(x.shape[0])
        return x[self.rank * n:(self.rank + 1) * n]


def current_layout(device=None) -> Layout:
    """The layout of the active process group (one process without one)."""
    dev = torch.device("cpu") if device is None else torch.device(device)
    return Layout(collectives.rank(), collectives.world_size(),
                  int(os.environ.get("LOCAL_RANK", "0")), dev)


def take_rows(params: Any, layout: Layout) -> Any:
    """``params`` (a NamedTuple, tuple, list or dict of per-row tensors,
    drawn for the global batch) with every tensor cut to ``layout``'s
    rows; other leaves (an op order, ``None``) stay.  The same object at
    world 1."""
    if layout.world == 1:
        return params
    if isinstance(params, torch.Tensor):
        return layout.rows(params)
    if isinstance(params, tuple) and hasattr(params, "_fields"):
        return type(params)(*(take_rows(v, layout) for v in params))
    if isinstance(params, (tuple, list)):
        return type(params)(take_rows(v, layout) for v in params)
    if isinstance(params, dict):
        return {k: take_rows(v, layout) for k, v in params.items()}
    return params


def resolve_device(device) -> torch.device:
    """A CLI's device: ``"cuda"`` is ``cuda:LOCAL_RANK``; an explicit
    device (``"cuda:0"``, ``"cpu"``) is used as given.  A CUDA device with
    no card present raises: the CLIs never carry on on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return device


@contextlib.contextmanager
def process_group(device) -> Iterator[Layout]:
    """A CLI's run: resolve ``device``, join the process group that
    ``torchrun``'s environment describes (none for a plain run), yield the
    layout, and leave the group at the end if this call joined it.  A group
    the caller joined before stays."""
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    joined = not collectives.is_active()
    collectives.initialize(device=device)
    try:
        yield current_layout(device)
    finally:
        if joined:
            collectives.shutdown()
