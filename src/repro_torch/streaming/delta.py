"""Fixed-capacity delta segment — the mutable half of the streaming index.

Layout (capacity ``C``; one trash row at index ``C`` absorbs the padded
lanes of a batch, as in the reference):

  x          (C + 1, d)   inserted rows (same dtype as the frozen rows;
                          packed uint32 codes as int32 bit views for the
                          hamming metric)
  bucket_ids (C + 1, L)   per-table bucket of each row
  ids        (C + 1,)     external document ids
  live       (C + 1,)     False = empty slot or tombstoned; live[C] stays False
  count      host int     rows ever written (monotone until compaction reset)

Inserts and kills update the tensors in place (``index_put_``): no
query result keeps a reference to them.  ``count`` lives on the host, so
building the query's segment list reads no device scalar.  Queries treat
the delta as a small exact segment: per-table equality against
``bucket_ids`` replaces the CSR walk, and the counts are exact — they
drop for free when ``live`` flips off, which is why the delta needs no
sketch.  Queries read only the ``count`` rows written (``insert``
appends, so no later slot is ever live): on CUDA the equality test is
one launch of ``kernels/csrc/delta_collide.cu``, and an empty delta
launches nothing and adds no columns.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.engine import SegmentEstimate
from repro_torch.kernels import ops
from repro_torch.kernels.ref import no_columns, scan_epilogue
from repro_torch.obs.spans import span

__all__ = ["DeltaSegment", "DeltaView", "make_delta", "insert", "kill",
           "collision_stats", "search"]


@dataclasses.dataclass
class DeltaSegment:
    x: torch.Tensor            # (C + 1, d)
    bucket_ids: torch.Tensor   # (C + 1, L) int32
    ids: torch.Tensor          # (C + 1,) int32 external doc ids
    live: torch.Tensor         # (C + 1,) bool
    count: int = 0             # rows ever written

    @property
    def capacity(self) -> int:
        return self.x.shape[0] - 1


def make_delta(capacity: int, d: int, L: int, dtype=torch.float32,
               device=None) -> DeltaSegment:
    c = int(capacity)
    return DeltaSegment(
        x=torch.zeros((c + 1, d), dtype=dtype, device=device),
        bucket_ids=torch.full((c + 1, L), -1, dtype=torch.int32,
                              device=device),
        ids=torch.full((c + 1,), -1, dtype=torch.int32, device=device),
        live=torch.zeros((c + 1,), dtype=torch.bool, device=device),
        count=0)


def insert(delta: DeltaSegment, rows: torch.Tensor, bids: torch.Tensor,
           ext_ids: torch.Tensor, valid: torch.Tensor) -> DeltaSegment:
    """Append a padded batch in place; invalid lanes land on the trash
    row.  Several lanes may write the trash row, in no set order, so the
    only fact about it that holds is the ``live[C] = False`` written
    after them."""
    k = valid.shape[0]
    slot = delta.count + torch.arange(k, dtype=torch.int64,
                                      device=valid.device)
    idx = torch.where(valid, slot,
                      torch.full_like(slot, delta.capacity))
    delta.x.index_put_((idx,), rows.to(delta.x.dtype))
    delta.bucket_ids.index_put_((idx,), bids.to(torch.int32))
    delta.ids.index_put_((idx,), ext_ids.to(torch.int32))
    delta.live.index_put_((idx,), valid)
    delta.live[delta.capacity] = False
    delta.count += int(valid.sum())
    return delta


def kill(delta: DeltaSegment, slots: torch.Tensor,
         valid: torch.Tensor) -> DeltaSegment:
    """Tombstone delta slots in place (invalid lanes hit the trash row)."""
    idx = torch.where(valid, slots.to(torch.int64),
                      torch.full_like(slots, delta.capacity,
                                      dtype=torch.int64))
    delta.live[idx] = False
    return delta


@dataclasses.dataclass
class DeltaView:
    """Engine ``Segment`` adapter for the exact, sketch-free delta.

    Counts are exact (no HLL, no dead-count correction), so its
    ``SegmentEstimate`` carries ``cand_exact`` only.  ``n_live``/
    ``n_scan`` are host ints supplied by the owner.  Its exact counts
    run in the profiler span ``hlsh.delta.counts`` and its LSH route in
    ``hlsh.delta.search`` (``repro_torch.obs.spans``); its linear route is
    its ``scan_part`` in the group's ``ops.grouped_linear_scan``.
    """

    delta: DeltaSegment
    metric: str
    impl: Optional[str] = None
    n_live: int = 0
    n_scan: int = 0
    tidx: Optional[torch.Tensor] = None   # (V,) multi-probe column->table

    def estimate_terms(self, qbuckets: torch.Tensor) -> SegmentEstimate:
        with span("hlsh.delta.counts"):
            coll, dist = collision_stats(self.delta, qbuckets,
                                         tidx=self.tidx, impl=self.impl)
        return SegmentEstimate(collisions=coll, cand_exact=dist,
                               n_live=self.n_live, n_scan=self.n_scan)

    def search(self, qbuckets: torch.Tensor, q: torch.Tensor, r):
        with span("hlsh.delta.search"):
            return scan_epilogue(*search(self.delta, qbuckets, q, r,
                                         self.metric, impl=self.impl,
                                         tidx=self.tidx),
                                 None, self.delta.ids)

    def scan_part(self) -> ops.ScanPart:
        """What ``ops.grouped_linear_scan`` scans of the delta: the
        ``count`` rows written, masked by ``live``, reported by external
        id."""
        d = self.delta
        return ops.ScanPart(d.x[:d.count], d.live[:d.count],
                            d.ids[:d.count])

    def count_candidates(self, qbuckets: torch.Tensor) -> torch.Tensor:
        """(Q,) distinct colliding delta rows — exact, the delta keeps
        no sketches and its LSH route has no gather cap."""
        with span("hlsh.delta.counts"):
            return collision_stats(self.delta, qbuckets, tidx=self.tidx,
                                   impl=self.impl)[1]


def collision_stats(delta: DeltaSegment, qbuckets: torch.Tensor,
                    tidx: Optional[torch.Tensor] = None,
                    impl: Optional[str] = None):
    """Exact per-query delta counts: (collisions, distinct), both (Q,)
    int32 — the streaming analogue of ``bucket_counts`` + the HLL
    candSize term, except both are exact (and tombstone-aware through
    ``live``).  Over the ``count`` rows written, the only slots that can
    be live: ``ops.delta_collide`` (one launch on CUDA, none for an empty
    delta)."""
    n = delta.count
    return ops.delta_collide(qbuckets, delta.bucket_ids[:n], delta.live[:n],
                             tidx, "counts", impl=impl)


def search(delta: DeltaSegment, qbuckets: torch.Tensor, q: torch.Tensor,
           r: float, metric: str, impl: Optional[str] = None,
           tidx: Optional[torch.Tensor] = None):
    """The delta's LSH route -> (ext_ids, dists, mask), (Q, count): the
    rows written, the only slots that can be live.

    A delta row is a candidate only if it collides in >= 1 probed bucket.
    The distance + threshold pass is the fused linear-route kernel
    (``ops.fused_linear_scan``: K1, K4 or K5 by metric) over those rows;
    the collision test's mask of live colliding rows
    (``ops.delta_collide``) composes on top.  An empty delta gives
    zero-width tensors and launches nothing.
    """
    n = delta.count
    if n == 0:
        return no_columns(q)
    _, dists, mask = ops.fused_linear_scan(q, delta.x[:n], r, metric,
                                           impl=impl)
    mask = mask & ops.delta_collide(qbuckets, delta.bucket_ids[:n],
                                    delta.live[:n], tidx, "mask", impl=impl)
    ids = delta.ids[None, :n].expand(dists.shape)
    return ids, dists, mask
