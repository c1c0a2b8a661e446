"""Parallelism context threaded through the model zoo.

The port runs one device.  ``ParallelConfig`` keeps the reference's
single-device knobs (the attention chunks; ``remat`` and the logits
chunk, which training will read) so that callers pass the same values;
a ``mesh`` other than None raises ``NotImplementedError``: multi-device
execution, and the sharding fields and helpers that go with it, come
with the port's Slice E.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

__all__ = ["ParallelConfig"]


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    mesh: Optional[Any] = None
    remat: str = "block"          # none | block (training only)
    logits_chunk: int = 2048      # seq chunk for the CE loss (training)
    attn_chunk_q: int = 512
    attn_chunk_k: int = 512

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "ParallelConfig(mesh=...): multi-device execution is not "
                "ported yet (Slice E); pass mesh=None")
