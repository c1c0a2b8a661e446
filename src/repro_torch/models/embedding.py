"""Token embedding and greedy sampling (one device).

``repro.models.embedding`` shards the (V, D) tables over a mesh's model
axis; on one device both functions are the dense ops it falls back to.
The chunked cross-entropy comes with training (Slice F).
"""
from __future__ import annotations

import torch

from repro_torch.models.common import dense_init


def init_table(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.bfloat16, device=None) -> torch.Tensor:
    return dense_init(gen, (vocab, d), 1, dtype=dtype, device=device)


def embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table: (V, D); ids: any shape -> ids.shape + (D,)."""
    return table[ids]


def greedy_sample(head: torch.Tensor, h_last: torch.Tensor) -> torch.Tensor:
    """argmax_v (h_last @ head.T) in float32.  h_last: (B, D) -> (B,)
    int32."""
    logits = h_last.float() @ head.float().T
    return torch.argmax(logits, dim=-1).to(torch.int32)
