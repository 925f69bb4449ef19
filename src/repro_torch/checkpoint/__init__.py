"""Atomic, async checkpoints in the reference's on-disk format (mirrors
`repro.checkpoint`)."""
from repro_torch.checkpoint.manager import (CheckpointManager,
                                            load_checkpoint, save_checkpoint)

__all__ = ["CheckpointManager", "load_checkpoint", "save_checkpoint"]
