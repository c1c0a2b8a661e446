"""Token embedding, chunked cross-entropy, greedy sampling (one device).

``repro.models.embedding`` shards the (V, D) tables over a mesh's model
axis; on one device each function is the dense op it falls back to.  The
loss never materializes the (B, S, V) logits: it runs over sequence
chunks, each under ``torch.utils.checkpoint`` so that the backward pass
recomputes the chunk's (B, C, V) logits instead of keeping them.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import dense_init


def init_table(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.bfloat16, device=None) -> torch.Tensor:
    return dense_init(gen, (vocab, d), 1, dtype=dtype, device=device)


def embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table: (V, D); ids: any shape -> ids.shape + (D,)."""
    return table[ids]


def _chunk_loss(head: torch.Tensor, hc: torch.Tensor, lc: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """hc: (B, C, D); lc: (B, C) -> (sum of the valid rows' NLL, their
    count), float32."""
    logits = hc.float() @ head.float().T                # (B, C, V)
    nll = (torch.logsumexp(logits, dim=-1)
           - torch.gather(logits, -1,
                          torch.clamp(lc, min=0)[..., None])[..., 0])
    valid = lc >= 0
    return (torch.sum(torch.where(valid, nll, 0.0)),
            torch.sum(valid.to(torch.float32)))


def softmax_xent(head: torch.Tensor, h: torch.Tensor, labels: torch.Tensor,
                 chunk: int = 2048) -> torch.Tensor:
    """Mean CE of ``h @ head.T`` against ``labels``, over sequence chunks.

    h: (B, S, D); labels: (B, S) int64 with -1 = ignore.  Returns a
    float32 0-d tensor: the sum over the count of valid labels (at least
    1)."""
    b, s, d = h.shape
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"sequence {s} is not a multiple of the logits "
                         f"chunk {c}")
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, s, c):
        sl, cnt = checkpoint(_chunk_loss, head, h[:, i:i + c],
                             labels[:, i:i + c], use_reentrant=False)
        total = total + sl
        count = count + cnt
    return total / torch.clamp(count, min=1.0)


def greedy_sample(head: torch.Tensor, h_last: torch.Tensor) -> torch.Tensor:
    """argmax_v (h_last @ head.T) in float32.  h_last: (B, D) -> (B,)
    int32."""
    logits = h_last.float() @ head.float().T
    return torch.argmax(logits, dim=-1).to(torch.int32)
