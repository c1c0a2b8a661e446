"""Checkpointing: the ``CheckpointManager`` (full and content-addressed
incremental snapshots, atomic commits, crash-litter sweep, index and
collection-tree restores) and the content address of one array
(``array_digest``), which the frozen segments' digests use."""
from repro_torch.checkpoint.manager import CheckpointManager, array_digest

__all__ = ["CheckpointManager", "array_digest"]
