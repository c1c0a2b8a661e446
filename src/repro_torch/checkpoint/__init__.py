"""Checkpointing.  This slice carries only the content address of one
array (``array_digest``), which the frozen segments' digests use."""
from repro_torch.checkpoint.manager import array_digest

__all__ = ["array_digest"]
