"""Utilities: logging/metrics, meters, seeding, visual artifacts."""

from cp2_tpu_torch.utils.logging import (
    AverageMeter,
    MetricLogger,
    NullSink,
    ProgressMeter,
    setup_logger,
)
from cp2_tpu_torch.utils.seed import seed_everything

__all__ = [
    "AverageMeter",
    "MetricLogger",
    "NullSink",
    "ProgressMeter",
    "setup_logger",
    "seed_everything",
]
