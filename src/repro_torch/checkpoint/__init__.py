"""Atomic, async checkpoints in the reference's on-disk format."""

from repro_torch.checkpoint.manager import (CheckpointManager, latest_step,  # noqa: F401
                                            restore_checkpoint, save_checkpoint)
