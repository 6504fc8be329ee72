"""Atomic checkpoints in the JAX package's on-disk format (store.py)."""
from .store import (CheckpointManager, atomic_write_json, latest_step,
                    restore_checkpoint, restore_like, restore_resharded,
                    save_checkpoint)

__all__ = ["CheckpointManager", "atomic_write_json", "latest_step",
           "restore_checkpoint", "restore_like", "restore_resharded",
           "save_checkpoint"]
