"""Token embedding, chunked cross-entropy, greedy sampling.

Without a mesh each function is the dense op.  Under a mesh (``par``
active) the (V, D) tables are sharded over the model axis on V, as in
``repro.models.embedding``'s ``shard_map`` sites: each model shard takes
its V / n rows, computes its part, and the parts meet in the mesh's
collectives:

  * ``embed``: each shard looks up the ids in its rows (0 elsewhere); a
    psum over the model axis;
  * ``softmax_xent``: each shard's (B, C, V / n) logits of a chunk; the
    global max of the shards' maxima (all_gather, then max; detached, as
    the reference's ``stop_gradient``: the shift cancels in the
    gradient), psums of the exp-sums and of the label's logit;
  * ``greedy_sample``: each shard's max and first argmax; a pmax, then a
    pmin of the ids of the shards that hold the max, so that a tie goes
    to the lowest id.

A batch row's result needs no other row, so the batch's data shards run
as one batched op: the shards looped over are the model axis's.

The loss never materializes the (B, S, V) logits: it runs over sequence
chunks, each under ``torch.utils.checkpoint`` so that the backward pass
recomputes the chunk's logits instead of keeping them.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import dense_init


def init_table(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.bfloat16, device=None) -> torch.Tensor:
    return dense_init(gen, (vocab, d), 1, dtype=dtype, device=device)


def _vocab_shards(table: torch.Tensor, par):
    """The model axis's mesh and each shard's (offset, rows) of a (V, D)
    table."""
    mesh = par.mesh.sub(par.model_axis)
    v, n = table.shape[0], mesh.size
    if v % n:
        raise ValueError(f"vocab {v} does not split over {n} model shards")
    v_loc = v // n
    return mesh, [(r * v_loc, table[r * v_loc:(r + 1) * v_loc])
                  for r in range(n)]


def _local_ids(ids: torch.Tensor, off: int, v_loc: int):
    """Ids relative to a shard's first row, clamped into it, and whether
    the shard holds them."""
    lid = ids - off
    ok = (lid >= 0) & (lid < v_loc)
    return torch.clamp(lid, 0, v_loc - 1), ok


# ----------------------------------------------------------------- embed
def embed(table: torch.Tensor, ids: torch.Tensor, par=None) -> torch.Tensor:
    """table: (V, D); ids: any shape -> ids.shape + (D,)."""
    if not (par is not None and par.active):
        return table[ids]
    mesh, shards = _vocab_shards(table, par)
    parts = []
    for off, tab in shards:
        lid, ok = _local_ids(ids, off, tab.shape[0])
        parts.append(torch.where(ok[..., None], tab[lid], 0))
    return mesh.psum(parts)[0]


# ------------------------------------------------------------------ loss
def _chunk_loss(head: torch.Tensor, hc: torch.Tensor, lc: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """hc: (B, C, D); lc: (B, C) -> (sum of the valid rows' NLL, their
    count), float32."""
    logits = hc.float() @ head.float().T                # (B, C, V)
    nll = (torch.logsumexp(logits, dim=-1)
           - torch.gather(logits, -1,
                          torch.clamp(lc, min=0)[..., None])[..., 0])
    return _masked_sum(nll, lc)


def _chunk_loss_sharded(head: torch.Tensor, hc: torch.Tensor,
                        lc: torch.Tensor, par):
    """``_chunk_loss`` with the vocabulary over the model shards."""
    mesh, shards = _vocab_shards(head, par)
    logits: List[torch.Tensor] = [hc.float() @ hd.float().T
                                  for _, hd in shards]   # (B, C, V / n)
    m = [g.amax(dim=0).detach() for g in mesh.all_gather(
        [lg.amax(dim=-1) for lg in logits])]
    se = mesh.psum([torch.exp(lg - mr[..., None]).sum(dim=-1)
                    for lg, mr in zip(logits, m)])
    labs = []
    for (off, hd), lg in zip(shards, logits):
        lid, ok = _local_ids(lc, off, hd.shape[0])
        lab = torch.gather(lg, -1, lid[..., None])[..., 0]
        labs.append(torch.where(ok, lab, 0.0))
    lab = mesh.psum(labs)
    return _masked_sum(torch.log(se[0]) + m[0] - lab[0], lc)


def _masked_sum(nll: torch.Tensor, lc: torch.Tensor):
    valid = lc >= 0
    return (torch.sum(torch.where(valid, nll, 0.0)),
            torch.sum(valid.to(torch.float32)))


def softmax_xent(head: torch.Tensor, h: torch.Tensor, labels: torch.Tensor,
                 par=None, chunk: int = 2048) -> torch.Tensor:
    """Mean CE of ``h @ head.T`` against ``labels``, over sequence chunks.

    h: (B, S, D); labels: (B, S) int64 with -1 = ignore.  Returns a
    float32 0-d tensor: the sum over the count of valid labels (at least
    1)."""
    b, s, d = h.shape
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"sequence {s} is not a multiple of the logits "
                         f"chunk {c}")
    sharded = par is not None and par.active
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, s, c):
        hc, lc = h[:, i:i + c], labels[:, i:i + c]
        if sharded:
            sl, cnt = checkpoint(_chunk_loss_sharded, head, hc, lc, par,
                                 use_reentrant=False)
        else:
            sl, cnt = checkpoint(_chunk_loss, head, hc, lc,
                                 use_reentrant=False)
        total = total + sl
        count = count + cnt
    return total / torch.clamp(count, min=1.0)


# --------------------------------------------------------------- decode
def greedy_sample(head: torch.Tensor, h_last: torch.Tensor, par=None
                  ) -> torch.Tensor:
    """argmax_v (h_last @ head.T) in float32, the lowest id among equal
    maxima.  h_last: (B, D) -> (B,) int32."""
    if not (par is not None and par.active):
        logits = h_last.float() @ head.float().T
        return torch.argmax(logits, dim=-1).to(torch.int32)
    mesh, shards = _vocab_shards(head, par)
    loc_max, loc_arg = [], []
    for off, hd in shards:
        logits = h_last.float() @ hd.float().T
        loc_max.append(logits.amax(dim=-1))
        loc_arg.append(torch.argmax(logits, dim=-1).to(torch.int32) + off)
    g_max = mesh.pmax(loc_max)
    cand = [torch.where(lm >= gm, la, 2 ** 30)
            for lm, gm, la in zip(loc_max, g_max, loc_arg)]
    return mesh.pmin(cand)[0]
