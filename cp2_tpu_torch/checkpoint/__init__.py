"""Checkpointing: ``torch.save`` persistence and the flax ⇄ torch bridge."""

from cp2_tpu_torch.checkpoint.io import (
    gc_checkpoints,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
    wait_for_checkpoints,
)

__all__ = [
    "gc_checkpoints",
    "latest_checkpoint",
    "restore_checkpoint",
    "save_checkpoint",
    "wait_for_checkpoints",
]
