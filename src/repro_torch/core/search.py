"""The two search strategies the hybrid router chooses between.

Both run through the fused scan kernels behind the ``ops`` dispatch:

  * ``linear_search`` — fused brute-force scan (Eq. 2 cost): distance +
                        threshold + report mask + ids in one kernel pass
                        over (Q, N).
  * ``lsh_search``    — fixed-capacity bucket gather, then one fused
                        kernel over the (Q, C) unsorted candidates: their
                        sort, run dedup, row gather, rowwise distance and
                        threshold (Eq. 1 cost), one launch for the whole
                        group.  The reference sorts the candidates with
                        ``jnp.sort`` and then runs its verification
                        kernel; the plain version here does the same with
                        ``torch.sort``.

Reporting semantics: every function returns ``(ids, dists, mask)`` where
``mask[q, i]`` marks a reported r-near neighbor of query q.  Buffers are
sentinel-padded; ``mask`` already excludes padding.

The plain versions process a query batch in fixed ``q_chunk`` slices
(``ops.chunked``) so the per-chunk working set stays bounded; a batch
that is not a chunk multiple is padded up and the results sliced back
(a 33-query batch runs as two 32-query chunks).  On CUDA ``lsh_search``
does not slice (``ops.lsh_group_scan``); ``linear_search``'s K1 / K4 do.

``linear_search`` is the counterpart of ``repro.core.search.
linear_search``; the indexes' linear route is ``ops.grouped_linear_scan``
(``QueryEngine.search_group``), which slices its queries the same way.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.lsh.tables import LSHTables, gather_candidates
from repro_torch.kernels import ops
from repro_torch.kernels import ref as _ref

__all__ = ["linear_search", "lsh_search", "lsh_candidate_counts",
           "dedupe_sorted", "rowwise_dist"]


def rowwise_dist(rows: torch.Tensor, q: torch.Tensor,
                 metric: str) -> torch.Tensor:
    """rows: (..., C, d) candidates vs q: (..., d) -> (..., C) distances
    (squared for L2).  Delegates to ``kernels.ref.rowwise_dist``."""
    return _ref.rowwise_dist(rows, q, metric)


def dedupe_sorted(cands: torch.Tensor,
                  sentinel: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort (Q, C) candidate ids and mask duplicates / sentinels.

    Returns (sorted_ids, first_occurrence_mask): the sort-based stand-in
    for the paper's hash-set duplicate removal, whose cost is the
    alpha-term of Eq. (1).
    """
    s = torch.sort(cands, dim=-1).values
    first = torch.cat([torch.ones(s.shape[:-1] + (1,), dtype=torch.bool,
                                  device=s.device),
                       s[..., 1:] != s[..., :-1]], dim=-1)
    return s, first & (s < sentinel)


def linear_search(x: torch.Tensor, q: torch.Tensor, r: float, metric: str,
                  impl: str | None = None, q_chunk: int = 32,
                  x_unit: torch.Tensor | None = None):
    """Brute-force scan.  Returns (ids (Q,n), dists (Q,n), mask (Q,n)).

    One fused kernel per chunk of ``q_chunk`` queries: distances,
    threshold compare, report mask and candidate ids leave the kernel
    together (``ops.fused_linear_scan``).  For cosine, ``x_unit`` (x's
    unit rows, made once per corpus) spares the kernel route from
    normalising the corpus for every chunk.
    """
    return ops.chunked(lambda a: ops.fused_linear_scan(
        a[0], x, r, metric, impl=impl, x_unit=x_unit), (q,), (0,), q_chunk)


def lsh_candidate_counts(tables: LSHTables, qbuckets: torch.Tensor, cap: int,
                         tidx: torch.Tensor | None = None) -> torch.Tensor:
    """(Q,) distinct candidates ``lsh_search`` would gather per query:
    the same cap-truncated gather + sort-dedup, counting instead of
    verifying."""
    sentinel = tables.n
    cands = gather_candidates(tables, qbuckets, cap, sentinel, tidx=tidx)
    _, uniq = dedupe_sorted(cands, sentinel)
    return torch.sum(uniq, dim=-1, dtype=torch.int32)


def lsh_search(x: torch.Tensor, tables: LSHTables, qbuckets: torch.Tensor,
               q: torch.Tensor, r: float, metric: str, cap: int,
               q_chunk: int = 32, tidx: torch.Tensor | None = None,
               impl: str | None = None, x_unit: torch.Tensor | None = None):
    """LSH-based search (steps S2+S3).

    x: (n, d) database rows (or (n, W) packed codes for hamming);
    qbuckets: (Q, V) bucket of each query per probed table (V = L, or
    L*T with ``tidx`` mapping probe columns to physical tables);
    q: (Q, d) queries.  Returns (ids (Q, V*cap), dists, mask) — ids
    sorted per query, deduped, verified.  The unsorted candidate ids go
    to ``ops.lsh_group_scan``: on CUDA one kernel launch sorts and
    verifies all Q queries' candidates; the plain version runs
    ``q_chunk`` slices, whose pad rows carry all-sentinel candidates, so
    they mask themselves.  For cosine, ``x_unit`` (x's unit rows, made
    once per corpus) is what the kernel gathers.
    """
    cands = gather_candidates(tables, qbuckets, cap, x.shape[0],
                              tidx=tidx)                        # (Q, C)
    return ops.lsh_group_scan(x, cands, q, r, metric, impl=impl,
                              x_unit=x_unit, q_chunk=q_chunk)
