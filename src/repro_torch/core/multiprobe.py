"""Query-directed multi-probe on top of the Hybrid LSH index.

The paper's Sec. 5 names multi-probe LSH (Lv et al. '07) as the natural
next target for HLL-based cost estimation, because multi-probe examines
many buckets per table and therefore aggravates the duplicate-removal
bottleneck.  It is implemented for SimHash: per table, probe the base
bucket plus the buckets reached by flipping the T-1 bits with the
smallest projection margin |a.x| (those are the likeliest sign errors).

The cost model extends verbatim: #collisions sums over the L*T probed
buckets and candSize merges their L*T HLLs — the estimate stays O(m*L*T)
and the hybrid routing decision covers the whole probe set.

uint32 codes are carried in int64 tensors (``repro_torch.u32``); a flip
is an XOR with a one-bit mask below 2**32, so no result leaves that
range.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.lsh.families import SimHash, mix_words
from repro_torch.core.lsh.tables import (LSHTables, bucket_counts,
                                         gather_candidates, gather_registers)
from repro_torch.u32 import as_u32

__all__ = ["probe_codes", "probe_buckets", "flatten_probes",
           "multiprobe_counts", "multiprobe_registers",
           "multiprobe_candidates"]


def probe_codes(fam: SimHash, params, queries: torch.Tensor,
                num_probes: int) -> torch.Tensor:
    """(Q, d) -> probe fingerprints (Q, L, T, W) uint32 (int64 tensor).

    Probe 0 is the base code; probe t>0 flips the t-th smallest-margin
    bit of that table's code (single-bit perturbations, the dominant
    terms of the Lv et al. probing sequence).  Equal margins keep bit
    order (a stable sort, as ``jnp.argsort``).
    """
    if num_probes - 1 > fam.k:
        raise ValueError(f"num_probes - 1 = {num_probes - 1} exceeds the "
                         f"{fam.k} bits of a code")
    codes = as_u32(fam.codes(params, queries))            # (Q, L, W)
    margins = fam.margins(params, queries)                # (Q, L, k)
    order = torch.argsort(margins, dim=-1, stable=True)   # ascending margin
    flip_pos = order[..., :max(num_probes - 1, 0)]        # (Q, L, T-1)

    w = codes.shape[-1]
    word = flip_pos // 32                                 # (Q, L, T-1)
    bit = flip_pos % 32
    onehot_word = torch.nn.functional.one_hot(word, w)    # (Q, L, T-1, W)
    flip_mask = onehot_word * (torch.ones_like(bit) << bit)[..., None]
    flipped = codes[:, :, None, :] ^ flip_mask            # (Q, L, T-1, W)
    return torch.cat([codes[:, :, None, :], flipped], dim=2)


def probe_buckets(fam: SimHash, params, queries: torch.Tensor,
                  num_probes: int, num_buckets: int,
                  impl: Optional[str] = None) -> torch.Tensor:
    """(Q, d) -> probed bucket ids (Q, L, T) int32; the probe codes are
    mixed by ``families.mix_words`` (the bucket hash kernel on the card)."""
    pcodes = probe_codes(fam, params, queries, num_probes)
    return mix_words(pcodes, num_buckets, impl)


def flatten_probes(qbuckets_probe: torch.Tensor):
    """(Q, L, T) probe set -> ((Q, L*T) qbuckets, (L*T,) table map).

    Treat (table, probe) pairs as L*T virtual tables hitting the SAME
    physical table — repeat the table index per probe.  The returned
    pair plugs straight into the engine segments: pass the flat buckets
    as ``qbuckets`` and the map as each segment's ``tidx``, and the
    whole pipeline (estimate terms, dead-count correction, candidate
    gather, delta equality scan) runs over the probed bucket set.
    """
    q, L, t = qbuckets_probe.shape
    tidx = torch.repeat_interleave(
        torch.arange(L, dtype=torch.int32, device=qbuckets_probe.device), t)
    return qbuckets_probe.reshape(q, L * t), tidx


def multiprobe_counts(tables: LSHTables, qb_probe: torch.Tensor) -> torch.Tensor:
    """(Q, L, T) probed buckets -> (Q, L*T) bucket sizes."""
    flatb, tidx = flatten_probes(qb_probe)
    return bucket_counts(tables, flatb, tidx=tidx)


def multiprobe_registers(tables: LSHTables,
                         qb_probe: torch.Tensor) -> torch.Tensor:
    """(Q, L, T) probed buckets -> (Q, L*T, m) HLL registers."""
    flatb, tidx = flatten_probes(qb_probe)
    return gather_registers(tables, flatb, tidx=tidx)


def multiprobe_candidates(tables: LSHTables, qb_probe: torch.Tensor, cap: int,
                          sentinel: int) -> torch.Tensor:
    """(Q, L, T) probed buckets -> (Q, L*T*cap) candidate ids."""
    flatb, tidx = flatten_probes(qb_probe)
    return gather_candidates(tables, flatb, cap, sentinel, tidx=tidx)
