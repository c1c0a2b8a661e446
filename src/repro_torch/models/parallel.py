"""Parallelism context threaded through the model zoo.

The port runs one device.  ``ParallelConfig`` keeps the reference's
single-device knobs so that callers pass the same values: the attention
chunks, the logits chunk of the training loss, and ``remat`` ("block":
``forward_train`` recomputes each layer in the backward pass; "none":
it keeps the layers' activations).  A ``mesh`` other than None raises
``NotImplementedError``: model parallelism (the sharding fields and
helpers, and the sequence-sharded decode) comes with Slice F3, and the
training knobs ``attn_remat``, ``attn_probs_bf16``, ``ssm_remat`` and
``moe_local_dispatch`` with the layer kinds that read them (Slice F2).
The sharded index runs on ``core.distributed.ShardMesh`` without it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

__all__ = ["ParallelConfig"]


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    mesh: Optional[Any] = None
    remat: str = "block"          # none | block (training only)
    logits_chunk: int = 2048      # seq chunk for the CE loss
    attn_chunk_q: int = 512
    attn_chunk_k: int = 512

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "ParallelConfig(mesh=...): model parallelism is not "
                "ported yet (Slice F3); pass mesh=None")
        if self.remat not in ("none", "block"):
            raise ValueError(f"remat={self.remat!r}: 'none' or 'block'")
