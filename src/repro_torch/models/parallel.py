"""Parallelism context threaded through the model zoo.

The port runs one device.  ``ParallelConfig`` keeps the reference's
single-device knobs so that callers pass the same values: the attention
chunks, the logits chunk of the training loss, ``remat`` ("block":
``forward_train`` recomputes each repeat of the block pattern, and each
tail layer, in the backward pass; "none": it keeps the layers'
activations) and the training knobs of the layer kinds:

  attn_remat       recompute each attention q chunk in the backward pass
  attn_probs_bf16  the p @ v product with bf16 probabilities (m and l
                   stay float32)
  ssm_remat        recompute each SSM chunk step in the backward pass

A ``mesh`` other than None, and ``moe_local_dispatch`` (the per-shard
MoE sort, which the reference takes only under a mesh), raise
``NotImplementedError``: model parallelism (the sharding fields and
helpers, the sequence-sharded decode, the local dispatch) comes with
Slice F3.  The sharded index runs on ``core.distributed.ShardMesh``
without it.
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
    attn_remat: bool = False
    attn_probs_bf16: bool = False
    ssm_remat: bool = False
    moe_local_dispatch: bool = False

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "ParallelConfig(mesh=...): model parallelism is not "
                "ported yet (Slice F3); pass mesh=None")
        if self.moe_local_dispatch:
            raise NotImplementedError(
                "ParallelConfig(moe_local_dispatch=True): the per-shard "
                "MoE dispatch needs a mesh and comes with Slice F3")
        if self.remat not in ("none", "block"):
            raise ValueError(f"remat={self.remat!r}: 'none' or 'block'")
