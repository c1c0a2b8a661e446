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
sketch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.engine import EXT_SENTINEL, SegmentEstimate
from repro_torch.kernels import ops

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
    ``n_scan`` are host ints supplied by the owner.
    """

    delta: DeltaSegment
    metric: str
    impl: Optional[str] = None
    n_live: int = 0
    n_scan: int = 0
    tidx: Optional[torch.Tensor] = None   # (V,) multi-probe column->table

    def estimate_terms(self, qbuckets: torch.Tensor) -> SegmentEstimate:
        coll, dist = collision_stats(self.delta, qbuckets, tidx=self.tidx)
        return SegmentEstimate(collisions=coll, cand_exact=dist,
                               n_live=self.n_live, n_scan=self.n_scan)

    def search(self, qbuckets: torch.Tensor, q: torch.Tensor, r, *,
               lsh_route: bool):
        ids, dists, mask = search(self.delta, qbuckets, q, r, self.metric,
                                  require_collision=lsh_route,
                                  impl=self.impl, tidx=self.tidx)
        return (torch.where(mask, ids, torch.full_like(ids, EXT_SENTINEL)),
                dists, mask)

    def count_candidates(self, qbuckets: torch.Tensor) -> torch.Tensor:
        """(Q,) distinct colliding delta rows — exact, the delta keeps
        no sketches and its LSH route has no gather cap."""
        return collision_stats(self.delta, qbuckets, tidx=self.tidx)[1]


def _row_buckets(delta: DeltaSegment,
                 tidx: Optional[torch.Tensor]) -> torch.Tensor:
    """(C + 1, V) per-row buckets aligned with the qbuckets columns.

    Identity for single-probe; under multi-probe each physical table's
    column repeats T times (``tidx``), so a probed query bucket compares
    against the row's bucket in the *same* physical table.
    """
    if tidx is None:
        return delta.bucket_ids
    return delta.bucket_ids[:, tidx.to(torch.int64)]


def _hits(delta: DeltaSegment, qbuckets: torch.Tensor,
          tidx: Optional[torch.Tensor]) -> torch.Tensor:
    """(Q, C + 1, V) bool: row bucket == query bucket, per column."""
    return (qbuckets[:, None, :].to(torch.int32)
            == _row_buckets(delta, tidx)[None, :, :])


def collision_stats(delta: DeltaSegment, qbuckets: torch.Tensor,
                    tidx: Optional[torch.Tensor] = None):
    """Exact per-query delta counts: (collisions, distinct), both (Q,)
    int32 — the streaming analogue of ``bucket_counts`` + the HLL
    candSize term, except both are exact (and tombstone-aware through
    ``live``)."""
    hit = _hits(delta, qbuckets, tidx) & delta.live[None, :, None]
    collisions = torch.sum(hit, dim=(1, 2), dtype=torch.int32)
    distinct = torch.sum(torch.any(hit, dim=-1), dim=1, dtype=torch.int32)
    return collisions, distinct


def search(delta: DeltaSegment, qbuckets: torch.Tensor, q: torch.Tensor,
           r: float, metric: str, require_collision: bool = True,
           impl: Optional[str] = None,
           tidx: Optional[torch.Tensor] = None):
    """Exact scan of the delta segment -> (ext_ids, dists, mask), (Q, C+1).

    ``require_collision=True`` mirrors LSH-route semantics (a delta row
    is a candidate only if it collides in >= 1 probed bucket); ``False``
    mirrors the linear route (every live row is checked).  The distance
    + threshold pass is the fused linear-route kernel
    (``ops.fused_linear_scan``: K1, K4 or K5 by metric) over all C + 1
    rows, whatever the route; the live/collision masks compose on top.
    """
    _, dists, in_radius = ops.fused_linear_scan(q, delta.x, r, metric,
                                                impl=impl)
    mask = in_radius & delta.live[None, :]
    if require_collision:
        mask = mask & torch.any(_hits(delta, qbuckets, tidx), dim=-1)
    ids = delta.ids[None, :].expand(dists.shape)
    return ids, dists, mask
