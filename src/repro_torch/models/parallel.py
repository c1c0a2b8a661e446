"""Parallelism context threaded through the model zoo.

The port runs one device.  ``ParallelConfig`` keeps the reference's
single-device knobs (the attention chunks; ``remat`` and the logits
chunk, which training will read) so that callers pass the same values;
a ``mesh`` other than None raises ``NotImplementedError``: model
parallelism (the sharding fields and helpers, and the sequence-sharded
decode) comes with the port's LM training stack, Slice F.  The sharded
index runs on ``core.distributed.ShardMesh`` without it.
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
                "ParallelConfig(mesh=...): model parallelism is not "
                "ported yet (Slice F); pass mesh=None")
