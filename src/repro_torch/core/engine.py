"""Segment engine — the one estimate→route→partition→search pipeline.

Every index of the port (the static ``HybridLSHIndex`` and the streaming
``DynamicHybridIndex``) is a composition over two concepts:

  * ``Segment``     — a searchable unit exposing its routing terms
                      (exact collisions, HLL registers or exact distinct
                      counts, tombstone dead counts, live/scan sizes)
                      and a fixed-shape search over its rows.
  * ``QueryEngine`` — owns Algorithm 2 once: gather per-segment terms,
                      combine them into a ``RouteEstimate``
                      (``finalize_route``), partition the query batch on
                      the host, and run both strategies over every
                      segment.

A static segment is one whose dead counts are zero and whose scan size
equals its live size, so ``finalize_route`` serves both indexes.  The
segment list has any length: the streaming index hands over its whole
LSM level stack (every frozen level + the delta) and the dead-count
correction composes term by term.  Multi-probe composes the same way: a
``tidx`` column→table map turns (Q, L*T) probed buckets into virtual
tables that every segment understands.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional, Protocol, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import hll as hll_lib
from repro_torch.core import search as search_lib
from repro_torch.core.cost_model import CostModel
from repro_torch.core.lsh.tables import (LSHTables, bucket_counts,
                                         gather_registers, table_index)
from repro_torch.kernels import ops

__all__ = ["RouteEstimate", "SegmentEstimate", "Segment", "TableSegment",
           "QueryEngine", "QueryResult", "finalize_route",
           "partition_indices", "compact_results", "EXT_SENTINEL",
           "estimate_routes", "estimate_routes_dynamic"]

EXT_SENTINEL = 2**31 - 1   # masked-out slots in reported buffers


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
    """One segment's contribution to the routing estimate.

    Exactly one of ``registers`` / ``merged_registers`` / ``cand_exact``
    normally carries the candSize term: CSR+HLL segments report raw
    ``(Q, L, m)`` registers (so the fused merge+estimate kernel applies),
    cross-shard merges report pre-merged ``(Q, m)`` registers, and
    sketch-free segments (the delta) report an exact distinct count.  A
    merged estimate may carry both a sketch and an exact term; they are
    summed.
    """

    collisions: torch.Tensor                         # (Q,) exact live
    dead_collisions: Optional[torch.Tensor] = None   # (Q,) or None (static)
    registers: Optional[torch.Tensor] = None         # (Q, L, m) uint8
    merged_registers: Optional[torch.Tensor] = None  # (Q, m)
    cand_exact: Optional[torch.Tensor] = None        # (Q,) exact distinct
    n_live: int = 0    # live rows this segment contributes
    n_scan: int = 0    # rows its linear scan computes distances over


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

    # Traced queries (``QueryEngine`` with a tracer) additionally call
    # ``count_candidates(qbuckets) -> (Q,)``: the distinct candidates
    # this segment's LSH route gathers (cap-truncated).


def finalize_route(terms: Sequence[SegmentEstimate], cost_model: CostModel,
                   *, impl: Optional[str] = None,
                   n_live: Optional[int] = None,
                   n_scan: Optional[int] = None) -> RouteEstimate:
    """Combine per-segment terms into the tombstone-aware RouteEstimate.

    collisions = sum of exact live collisions; candSize = sum over
    segments of (HLL estimate - dead collisions, clamped at 0) plus the
    exact distinct counts, clamped by the structural bounds (candSize is
    a distinct count, <= live #collisions and <= n_live).  Static
    segments simply have zero dead counts.  HLL registers are monotone
    (they never decrement), so the dead-count subtraction over-corrects
    slightly — a dead point colliding in several tables is subtracted
    once per table — biasing the churned estimate toward the LSH route,
    whose verification masks dead rows cheaply.  LinearCost is priced at
    ``n_scan``: the rows the linear route computes distances over
    (tombstoned or padded rows included — masking happens after the
    scan).
    """
    if not terms:
        raise ValueError("finalize_route needs at least one segment")
    collisions = terms[0].collisions
    for t in terms[1:]:
        collisions = collisions + t.collisions
    if n_live is None:
        n_live = sum(t.n_live for t in terms)
    if n_scan is None:
        n_scan = sum(t.n_scan for t in terms)

    coll_f = collisions.to(torch.float32)
    cand = torch.zeros_like(coll_f)
    for t in terms:
        if t.registers is not None:
            est = ops.hll_merge_estimate(t.registers, impl=impl)
        elif t.merged_registers is not None:
            est = hll_lib.estimate_from_registers(t.merged_registers)
        else:
            est = None
        if est is not None:
            if t.dead_collisions is not None:
                est = torch.clamp(
                    est - t.dead_collisions.to(torch.float32), min=0.0)
            cand = cand + est
        if t.cand_exact is not None:
            cand = cand + t.cand_exact.to(torch.float32)
    cand = torch.minimum(cand, torch.clamp(coll_f, max=float(n_live)))
    lsh_cost = cost_model.lsh_cost(coll_f, cand)
    linear_cost = cost_model.linear_cost(n_scan)
    return RouteEstimate(collisions=collisions, cand_est=cand,
                         lsh_cost=lsh_cost, linear_cost=linear_cost,
                         use_lsh=lsh_cost < linear_cost)


# ---------------------------------------------------------------------------
# The CSR+HLL segment (static index and the streaming frozen segments)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class TableSegment:
    """CSR tables + per-bucket HLLs, with optional tombstones/external ids.

    With the defaults this is the static index's segment: no dead
    counts, internal ids reported raw, every row live and scanned.  The
    streaming frozen segments supply ``live``/``tomb_counts``
    (tombstone-corrected estimates, dead rows masked after search) and
    ``ext_ids`` (external ids reported, with ``EXT_SENTINEL`` in masked
    slots).
    """

    tables: LSHTables
    x: Optional[torch.Tensor] = None         # (n, d) rows; None = estimate-only
    metric: str = "l2"
    cap: int = 64
    live: Optional[torch.Tensor] = None         # (n + 1,) bool
    tomb_counts: Optional[torch.Tensor] = None  # (L, B) int32
    ext_ids: Optional[torch.Tensor] = None      # (n,) int32
    n_live: Optional[int] = None                # defaults to tables.n
    n_scan: Optional[int] = None                # defaults to #rows scanned
    impl: Optional[str] = None
    q_chunk: Optional[int] = None               # None -> min(32, Q)
    tidx: Optional[torch.Tensor] = None         # (V,) multi-probe column->table
    x_unit: Optional[torch.Tensor] = None       # cosine: x's unit rows, for K1

    def estimate_terms(self, qbuckets: torch.Tensor) -> SegmentEstimate:
        counts = bucket_counts(self.tables, qbuckets, tidx=self.tidx)
        regs = gather_registers(self.tables, qbuckets, tidx=self.tidx)
        if self.tomb_counts is None:
            collisions = torch.sum(counts, dim=-1, dtype=torch.int32)
            dead = None
        else:
            lidx = table_index(self.tables, self.tidx)
            d = self.tomb_counts[lidx, qbuckets.to(torch.int64)]
            collisions = torch.sum(counts - d, dim=-1, dtype=torch.int32)
            dead = torch.sum(d, dim=-1, dtype=torch.int32)
        n_rows = self.tables.n if self.x is None else self.x.shape[0]
        n_live = self.tables.n if self.n_live is None else self.n_live
        n_scan = n_rows if self.n_scan is None else self.n_scan
        return SegmentEstimate(collisions=collisions, dead_collisions=dead,
                               registers=regs, n_live=n_live, n_scan=n_scan)

    def search(self, qbuckets: torch.Tensor, q: torch.Tensor, r, *,
               lsh_route: bool):
        if self.x is None:
            raise ValueError("estimate-only segment has no rows")
        n = self.x.shape[0]
        if lsh_route:
            qc = self.q_chunk or min(32, q.shape[0])
            ids, dists, mask = search_lib.lsh_search(
                self.x, self.tables, qbuckets, q, r, self.metric, self.cap,
                q_chunk=qc, tidx=self.tidx, impl=self.impl)
        else:
            ids, dists, mask = search_lib.linear_search(
                self.x, q, r, self.metric, impl=self.impl, x_unit=self.x_unit)
        if self.live is not None or self.ext_ids is not None:
            safe = ids.to(torch.int64).clamp(0, n - 1)
            if self.live is not None:
                mask = mask & self.live[safe]
            if self.ext_ids is not None:
                ids = torch.where(mask, self.ext_ids[safe],
                                  torch.full_like(ids, EXT_SENTINEL))
        return ids, dists, mask

    def count_candidates(self, qbuckets: torch.Tensor) -> torch.Tensor:
        """(Q,) distinct candidates the LSH route gathers (cap-truncated,
        tombstoned rows included — they cost gather + verification)."""
        return search_lib.lsh_candidate_counts(self.tables, qbuckets,
                                               self.cap, tidx=self.tidx)


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


def _pad_size(k: int, minimum: int = 8) -> int:
    """Round a row count up to a power of two (at least ``minimum``):
    the padded size of a frozen segment, as in the reference."""
    if k == 0:
        return 0
    return max(minimum, 1 << (k - 1).bit_length())


def compact_results(ids: torch.Tensor, dists: torch.Tensor,
                    mask: torch.Tensor, max_out: int):
    """Compact sentinel-padded (Q, C) results to fixed (Q, max_out).

    Keeps the ``max_out`` nearest reported neighbors per query (exact
    whenever the true output size <= max_out).  Among equal distances
    the lower column comes first, as ``lax.top_k`` orders them: a stable
    ascending sort, not ``torch.topk``, whose order of ties is not
    specified.
    """
    key = torch.where(mask, dists, torch.full_like(dists, float("inf")))
    srt, pos = torch.sort(key, dim=-1, stable=True)
    srt, pos = srt[..., :max_out], pos[..., :max_out]
    return (torch.gather(ids, -1, pos), srt,
            torch.gather(mask, -1, pos) & torch.isfinite(srt))


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------
class QueryEngine:
    """Owns the hybrid pipeline once, for any list of segments."""

    def __init__(self, cost_model: CostModel, impl: Optional[str] = None,
                 tracer=None):
        """Args: ``cost_model`` — Algorithm 2 constants (alpha, beta);
        ``impl`` — kernel impl override (``"ref"`` or ``"cuda"``);
        ``tracer`` — optional ``repro_torch.obs.QueryTracer`` (duck-typed,
        the engine never imports obs).  ``query`` takes the traced path
        only while ``tracer.enabled`` is true."""
        self.cost_model = cost_model
        self.impl = impl
        self.tracer = tracer

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
        return _concat(parts)

    def _route(self, route: RouteEstimate, nq: int, force: Optional[str]):
        if force == "lsh":
            use = np.ones(nq, bool)
        elif force == "linear":
            use = np.zeros(nq, bool)
        else:
            use = route.use_lsh.cpu().numpy()
        return use, partition_indices(use)

    def query(self, segments: Sequence[Segment], queries: torch.Tensor,
              qbuckets: torch.Tensor, r: float,
              force: Optional[str] = None) -> QueryResult:
        """Hybrid r-NN reporting over the segments.

        force: None (hybrid routing) | "lsh" | "linear" — the two
        baselines of the paper's Figure 2.  The routing decision comes to
        the host once per batch (one copy of ``use_lsh``).
        """
        tracer = self.tracer
        if tracer is not None and tracer.enabled and tracer.sample():
            return self._query_traced(segments, queries, qbuckets, r, force)
        nq = queries.shape[0]
        route = self.estimate(segments, qbuckets)
        _, (lsh_idx, lin_idx) = self._route(route, nq, force)

        def group(idx, lsh_route):
            sel = torch.as_tensor(idx, dtype=torch.int64,
                                  device=queries.device)
            return self.search_group(segments, qbuckets[sel], queries[sel],
                                     float(r), lsh_route=lsh_route)

        lsh_out = group(lsh_idx, True) if len(lsh_idx) else None
        lin_out = group(lin_idx, False) if len(lin_idx) else None
        return QueryResult(route=route, lsh_idx=lsh_idx, lin_idx=lin_idx,
                           lsh_out=lsh_out, lin_out=lin_out, n_queries=nq)

    def count_candidates(self, segments: Sequence[Segment],
                         qbuckets: torch.Tensor) -> torch.Tensor:
        """(Q,) distinct candidates the LSH route gathers, summed over
        segments (segments hold disjoint docs, so the sum is exact)."""
        total = segments[0].count_candidates(qbuckets)
        for s in segments[1:]:
            total = total + s.count_candidates(qbuckets)
        return total

    def _query_traced(self, segments: Sequence[Segment],
                      queries: torch.Tensor, qbuckets: torch.Tensor,
                      r: float, force: Optional[str]) -> QueryResult:
        """``query`` with phase timing + span recording (same result).

        Phase boundaries synchronise the device (``torch.cuda.synchronize``
        on a CUDA index) so the timings attribute device work to the
        phase that enqueued it — the reason this is a separate method
        instead of timers in the fast path.
        """
        tracer = self.tracer
        dev = queries.device

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        timings = {}
        seg_seconds = None
        t0 = time.perf_counter()
        route = self.estimate(segments, qbuckets)
        sync()
        timings["estimate"] = time.perf_counter() - t0

        nq = queries.shape[0]
        use, (lsh_idx, lin_idx) = self._route(route, nq, force)
        per_segment = (getattr(tracer, "per_segment_timing", False)
                       and len(segments) > 1)

        def timed_group(idx, lsh_route, label):
            sel = torch.as_tensor(idx, dtype=torch.int64, device=dev)
            qb, q = qbuckets[sel], queries[sel]
            t0 = time.perf_counter()
            if per_segment:
                parts, seg_t = [], []
                for si, s in enumerate(segments):
                    ts = time.perf_counter()
                    parts.append(s.search(qb, q, float(r),
                                          lsh_route=lsh_route))
                    sync()
                    seg_t.append((f"seg{si}", time.perf_counter() - ts))
                out = _concat(parts)
                seg_seconds[label] = seg_t
            else:
                out = self.search_group(segments, qb, q, float(r),
                                        lsh_route=lsh_route)
            sync()
            timings[label] = time.perf_counter() - t0
            return out

        if per_segment:
            seg_seconds = {}
        lsh_out = lin_out = None
        if len(lsh_idx):
            lsh_out = timed_group(lsh_idx, True, "search_lsh")
        if len(lin_idx):
            lin_out = timed_group(lin_idx, False, "search_linear")

        t0 = time.perf_counter()
        cand_actual = self.count_candidates(segments, qbuckets).cpu().numpy()
        timings["count_actual"] = time.perf_counter() - t0

        coll = route.collisions.cpu().numpy().astype(np.float64)
        lsh_cost_actual = np.asarray(self.cost_model.lsh_cost(
            coll, cand_actual.astype(np.float64)))
        tracer.record_batch(
            use_lsh=use,
            collisions=coll,
            cand_est=route.cand_est.cpu().numpy().astype(np.float64),
            cand_actual=cand_actual,
            lsh_cost_est=route.lsh_cost.cpu().numpy().astype(np.float64),
            lsh_cost_actual=lsh_cost_actual,
            linear_cost=float(route.linear_cost),
            probes=int(qbuckets.shape[1]),
            forced=force,
            phase_seconds=timings,
            segment_seconds=seg_seconds,
            kernel_impl=ops.resolve_impl(self.impl, dev))
        return QueryResult(route=route, lsh_idx=lsh_idx, lin_idx=lin_idx,
                           lsh_out=lsh_out, lin_out=lin_out, n_queries=nq)


def _concat(parts):
    """Concatenate per-segment ``(ids, dists, mask)`` along columns."""
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat([p[i] for p in parts], dim=-1) for i in range(3))


# ---------------------------------------------------------------------------
# Compatibility wrappers (the pre-engine estimator entry points)
# ---------------------------------------------------------------------------
def estimate_routes(tables: LSHTables, qbuckets: torch.Tensor,
                    cost_model: CostModel, n: int,
                    impl: Optional[str] = None) -> RouteEstimate:
    """O(m*L) per query, independent of bucket sizes (the paper's point)."""
    seg = TableSegment(tables=tables, n_live=n, n_scan=n)
    return finalize_route([seg.estimate_terms(qbuckets)], cost_model,
                          impl=impl)


def estimate_routes_dynamic(tables: LSHTables, qbuckets: torch.Tensor,
                            cost_model: CostModel, n_live: int, *,
                            tomb_counts: torch.Tensor,
                            delta_collisions: torch.Tensor,
                            delta_distinct: torch.Tensor,
                            n_scan: Optional[int] = None,
                            impl: Optional[str] = None) -> RouteEstimate:
    """Tombstone-corrected Algorithm 2 for a main+delta segment pair."""
    main = TableSegment(tables=tables, tomb_counts=tomb_counts)
    delta = SegmentEstimate(collisions=delta_collisions,
                            cand_exact=delta_distinct)
    return finalize_route([main.estimate_terms(qbuckets), delta], cost_model,
                          impl=impl, n_live=n_live,
                          n_scan=n_live if n_scan is None else n_scan)
