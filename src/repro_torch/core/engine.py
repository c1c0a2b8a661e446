"""Segment engine — the one estimate→route→partition→search pipeline.

An index is a composition over two concepts:

  * ``Segment``     — a searchable unit exposing its routing terms
                      (exact collisions, HLL registers, live/scan sizes)
                      and a fixed-shape search over its rows.
  * ``QueryEngine`` — owns Algorithm 2 once: gather per-segment terms,
                      combine them into a ``RouteEstimate``
                      (``finalize_route``), partition the query batch on
                      the host, and run both strategies over every
                      segment.

This slice of the port carries the static index: ``TableSegment``
without tombstones or external ids, and the untraced ``query`` path.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Protocol, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import search as search_lib
from repro_torch.core.cost_model import CostModel
from repro_torch.core.lsh.tables import (LSHTables, bucket_counts,
                                         gather_registers)
from repro_torch.kernels import ops

__all__ = ["RouteEstimate", "SegmentEstimate", "Segment", "TableSegment",
           "QueryEngine", "QueryResult", "finalize_route",
           "partition_indices"]


# ---------------------------------------------------------------------------
# Route estimate (Algorithm 2 lines 1-4, vectorized over the query batch)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class RouteEstimate:
    """Vectorized output of Algorithm 2 lines 1-4."""

    collisions: torch.Tensor   # (Q,) int32   exact live sum of bucket sizes
    cand_est: torch.Tensor     # (Q,) float32 HLL union estimate of candSize
    lsh_cost: torch.Tensor     # (Q,) float32 Eq. (1)
    linear_cost: float         # scalar       Eq. (2)
    use_lsh: torch.Tensor      # (Q,) bool    Algorithm 2 line 4


@dataclasses.dataclass
class SegmentEstimate:
    """One segment's contribution to the routing estimate: its exact
    collisions and its raw ``(Q, L, m)`` HLL registers, which the fused
    merge+estimate kernel turns into the candSize term."""

    collisions: torch.Tensor   # (Q,) exact sum of bucket sizes
    registers: torch.Tensor    # (Q, L, m) uint8
    n_live: int = 0            # live rows this segment contributes
    n_scan: int = 0            # rows its linear scan computes distances over


class Segment(Protocol):
    """Anything the engine can route over (duck-typed; no inheritance)."""

    def estimate_terms(self, qbuckets: torch.Tensor) -> SegmentEstimate:
        """(Q, L) query buckets -> this segment's routing terms."""
        ...

    def search(self, qbuckets: torch.Tensor, q: torch.Tensor, r, *,
               lsh_route: bool) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
        """Fixed-shape search -> sentinel-padded ``(ids, dists, mask)``."""
        ...


def finalize_route(terms: Sequence[SegmentEstimate], cost_model: CostModel,
                   *, impl: Optional[str] = None) -> RouteEstimate:
    """Combine per-segment terms into the RouteEstimate.

    collisions = sum of exact collisions; candSize = sum over segments of
    the HLL estimate, clamped by the structural bounds (candSize is a
    distinct count, <= #collisions and <= the live rows).  LinearCost is
    priced at the rows the linear route computes distances over.
    """
    if not terms:
        raise ValueError("finalize_route needs at least one segment")
    collisions = terms[0].collisions
    for t in terms[1:]:
        collisions = collisions + t.collisions
    n_live = sum(t.n_live for t in terms)
    n_scan = sum(t.n_scan for t in terms)

    coll_f = collisions.to(torch.float32)
    cand = torch.zeros_like(coll_f)
    for t in terms:
        cand = cand + ops.hll_merge_estimate(t.registers, impl=impl)
    cand = torch.minimum(cand, torch.clamp(coll_f, max=float(n_live)))
    lsh_cost = cost_model.lsh_cost(coll_f, cand)
    linear_cost = cost_model.linear_cost(n_scan)
    return RouteEstimate(collisions=collisions, cand_est=cand,
                         lsh_cost=lsh_cost, linear_cost=linear_cost,
                         use_lsh=lsh_cost < linear_cost)


# ---------------------------------------------------------------------------
# The CSR+HLL segment of the static index
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class TableSegment:
    """CSR tables + per-bucket HLLs over the rows ``x``: every row is
    live and the linear route scans all of them."""

    tables: LSHTables
    x: torch.Tensor                     # (n, d) rows
    metric: str = "l2"
    cap: int = 64
    impl: Optional[str] = None
    tidx: Optional[torch.Tensor] = None  # (V,) multi-probe column->table
    x_unit: Optional[torch.Tensor] = None  # cosine: x's unit rows, for K1

    def estimate_terms(self, qbuckets: torch.Tensor) -> SegmentEstimate:
        counts = bucket_counts(self.tables, qbuckets, tidx=self.tidx)
        regs = gather_registers(self.tables, qbuckets, tidx=self.tidx)
        return SegmentEstimate(collisions=torch.sum(counts, dim=-1,
                                                    dtype=torch.int32),
                               registers=regs, n_live=self.tables.n,
                               n_scan=self.x.shape[0])

    def search(self, qbuckets: torch.Tensor, q: torch.Tensor, r, *,
               lsh_route: bool):
        if lsh_route:
            return search_lib.lsh_search(
                self.x, self.tables, qbuckets, q, r, self.metric, self.cap,
                q_chunk=min(32, q.shape[0]), tidx=self.tidx, impl=self.impl)
        return search_lib.linear_search(self.x, q, r, self.metric,
                                        impl=self.impl, x_unit=self.x_unit)


# ---------------------------------------------------------------------------
# Query result + host-side partitioning helpers
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class QueryResult:
    """Per-strategy buffers + per-query bookkeeping.

    ``lsh_out``/``lin_out`` stay tensors on the index's device;
    ``neighbors(i)`` reads host copies made once, on first use.
    """

    route: RouteEstimate
    lsh_idx: np.ndarray          # query indices served by LSH search
    lin_idx: np.ndarray          # query indices served by linear search
    lsh_out: Optional[tuple]     # (ids, dists, mask) for the LSH group
    lin_out: Optional[tuple]     # (ids, dists, mask) for the linear group
    n_queries: int

    @functools.cached_property
    def _host(self):
        return [(np.asarray(idx), tuple(t.cpu().numpy() for t in out))
                for idx, out in ((self.lsh_idx, self.lsh_out),
                                 (self.lin_idx, self.lin_out))
                if out is not None]

    def _row(self, i: int):
        for idx, out in self._host:
            pos = np.nonzero(idx == i)[0]
            if len(pos):
                return out, pos[0]
        raise KeyError(i)

    def neighbors(self, i: int) -> np.ndarray:
        (ids, _, mask), row = self._row(i)
        return ids[row][mask[row]]

    def reported(self, i: int):
        """(ids, dists) reported for query ``i``."""
        (ids, dists, mask), row = self._row(i)
        m = mask[row]
        return ids[row][m], dists[row][m]

    def neighbor_sets(self):
        return {i: set(self.neighbors(i).tolist())
                for i in range(self.n_queries)}

    @property
    def n_linear(self) -> int:
        """Number of queries served by linear search."""
        return len(self.lin_idx)

    @property
    def frac_linear(self) -> float:
        return self.n_linear / max(self.n_queries, 1)


def partition_indices(use_lsh: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Split query indices into (lsh_idx, linear_idx).  Unpadded: the
    searches run eagerly, so group sizes cost no recompiles, and each
    search pads its group only up to a whole query chunk."""
    use_lsh = np.asarray(use_lsh, bool)
    return np.nonzero(use_lsh)[0], np.nonzero(~use_lsh)[0]


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------
class QueryEngine:
    """Owns the hybrid pipeline once, for any list of segments."""

    def __init__(self, cost_model: CostModel, impl: Optional[str] = None):
        """Args: ``cost_model`` — Algorithm 2 constants (alpha, beta);
        ``impl`` — kernel impl override (``"ref"`` or ``"cuda"``)."""
        self.cost_model = cost_model
        self.impl = impl

    def estimate(self, segments: Sequence[Segment],
                 qbuckets: torch.Tensor) -> RouteEstimate:
        """Algorithm 2 lines 1-4 over the whole segment list; ``qbuckets``
        is (Q, L), or (Q, V) virtual-table columns under multi-probe."""
        return finalize_route([s.estimate_terms(qbuckets) for s in segments],
                              self.cost_model, impl=self.impl)

    def search_group(self, segments: Sequence[Segment],
                     qbuckets: torch.Tensor, q: torch.Tensor, r, *,
                     lsh_route: bool):
        """Search every segment for one routed group; concatenate the
        sentinel-padded ``(ids, dists, mask)`` buffers along columns."""
        parts = [s.search(qbuckets, q, r, lsh_route=lsh_route)
                 for s in segments]
        if len(parts) == 1:
            return parts[0]
        return tuple(torch.cat([p[i] for p in parts], dim=-1)
                     for i in range(3))

    def query(self, segments: Sequence[Segment], queries: torch.Tensor,
              qbuckets: torch.Tensor, r: float,
              force: Optional[str] = None) -> QueryResult:
        """Hybrid r-NN reporting over the segments.

        force: None (hybrid routing) | "lsh" | "linear" — the two
        baselines of the paper's Figure 2.  The routing decision comes to
        the host once per batch (one copy of ``use_lsh``).
        """
        nq = queries.shape[0]
        route = self.estimate(segments, qbuckets)
        if force == "lsh":
            use = np.ones(nq, bool)
        elif force == "linear":
            use = np.zeros(nq, bool)
        else:
            use = route.use_lsh.cpu().numpy()
        lsh_idx, lin_idx = partition_indices(use)

        def group(idx, lsh_route):
            sel = torch.as_tensor(idx, dtype=torch.int64,
                                  device=queries.device)
            return self.search_group(segments, qbuckets[sel], queries[sel],
                                     float(r), lsh_route=lsh_route)

        lsh_out = group(lsh_idx, True) if len(lsh_idx) else None
        lin_out = group(lin_idx, False) if len(lin_idx) else None
        return QueryResult(route=route, lsh_idx=lsh_idx, lin_idx=lin_idx,
                           lsh_out=lsh_out, lin_out=lin_out, n_queries=nq)
