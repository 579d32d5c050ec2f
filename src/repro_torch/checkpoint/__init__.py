"""repro_torch.checkpoint — npz checkpoints in the reference's format."""

from .store import (
    CheckpointCorruptionError,
    latest_step,
    load_checkpoint,
    save_checkpoint,
)

__all__ = [
    "CheckpointCorruptionError",
    "load_checkpoint",
    "save_checkpoint",
    "latest_step",
]
