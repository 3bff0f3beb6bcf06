"""Sharded, redundant, async checkpoints of the port's training state."""

from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    CheckpointManager,
    save_checkpoint,
    restore_checkpoint,
    latest_step,
)
