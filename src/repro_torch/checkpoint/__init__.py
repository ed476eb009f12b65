"""Atomic checkpoints with auto-resume, in the JAX package's layout."""

from repro_torch.checkpoint.store import (
    AsyncCheckpointer,
    gc_checkpoints,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = ["AsyncCheckpointer", "gc_checkpoints", "latest_step",
           "restore_checkpoint", "save_checkpoint"]
