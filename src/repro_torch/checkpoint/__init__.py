"""Snapshot-consistent checkpoints (``snapshotter``)."""
from repro_torch.checkpoint.snapshotter import (  # noqa: F401
    CheckpointManager,
    SubmitOutcome,
    restore_checkpoint,
    save_checkpoint,
)
