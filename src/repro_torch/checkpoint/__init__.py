"""Checkpoints in the JAX package's layout."""
from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointManager, read_checkpoint,
)
