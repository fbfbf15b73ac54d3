"""More than one process: the layout of a run and its collectives.

Twin of ``cp2_tpu/parallel/`` on ``torch.distributed``; see ``mesh`` for
how a run is split and ``collectives`` for the collectives.
"""

from cp2_tpu_torch.parallel.collectives import (
    barrier,
    check_replicas,
    concat_all_gather,
    initialize,
    is_active,
    pmean_gradients,
    pmean_metrics,
    psum_metrics,
    rank,
    shutdown,
    world_size,
)
from cp2_tpu_torch.parallel.mesh import (
    Layout,
    current_layout,
    process_group,
    resolve_device,
    take_rows,
)

__all__ = [
    "Layout",
    "barrier",
    "check_replicas",
    "concat_all_gather",
    "current_layout",
    "initialize",
    "is_active",
    "pmean_gradients",
    "pmean_metrics",
    "process_group",
    "psum_metrics",
    "rank",
    "resolve_device",
    "shutdown",
    "take_rows",
    "world_size",
]
