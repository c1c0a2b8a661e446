"""Tombstones for the immutable frozen segments.

A frozen segment's CSR tables and per-bucket HyperLogLogs are immutable
(HLL registers are monotone — they cannot decrement), so deletes are
recorded on the side:

  live    (n + 1,)  bool   row liveness; the trash row at index n stays False
  counts  (L, B)    int32  dead entries per (table, bucket)

``counts`` is the exact correction term for the router: subtracting it
from the CSR bucket sizes gives exact *live* collisions, and subtracting
its per-query sum from the HLL union bounds the live candSize from below
(a dead point colliding in several tables is subtracted once per table).
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["Tombstones", "make_tombstones", "mark_dead", "dead_in_buckets"]


@dataclasses.dataclass
class Tombstones:
    live: torch.Tensor     # (n + 1,) bool
    counts: torch.Tensor   # (L, B) int32

    @property
    def n(self) -> int:
        return self.live.shape[0] - 1


def make_tombstones(n: int, L: int, num_buckets: int,
                    device=None) -> Tombstones:
    live = torch.ones((int(n) + 1,), dtype=torch.bool, device=device)
    live[int(n)] = False
    return Tombstones(live=live,
                      counts=torch.zeros((int(L), int(num_buckets)),
                                         dtype=torch.int32, device=device))


def mark_dead(ts: Tombstones, rows: torch.Tensor, row_buckets: torch.Tensor,
              valid: torch.Tensor) -> Tombstones:
    """Tombstone rows (padded batch); returns new tombstones.

    rows: (k,) segment row indices; row_buckets: (k, L) their bucket
    per table (callers pad invalid lanes with bucket 0 — they add 0
    there).  Rows sharing a (table, bucket) pair each add one: the
    counts accumulate over duplicate indices, as ``.at[].add`` does.
    The inputs are not modified (queries may still hold them).
    """
    idx = torch.where(valid, rows.to(torch.int64),
                      torch.full_like(rows, ts.n, dtype=torch.int64))
    live = ts.live.clone()
    live[idx] = False
    L = ts.counts.shape[0]
    lidx = torch.arange(L, dtype=torch.int64,
                        device=row_buckets.device)[None, :].expand(
                            row_buckets.shape)
    add = valid[:, None].expand(row_buckets.shape).to(torch.int32)
    counts = ts.counts.clone()
    counts.index_put_((lidx, row_buckets.to(torch.int64)), add,
                      accumulate=True)
    return Tombstones(live=live, counts=counts)


def dead_in_buckets(ts: Tombstones, qbuckets: torch.Tensor) -> torch.Tensor:
    """(Q, L) query buckets -> (Q, L) exact dead-entry counts."""
    lidx = torch.arange(ts.counts.shape[0], dtype=torch.int64,
                        device=qbuckets.device)[None, :]
    return ts.counts[lidx, qbuckets.to(torch.int64)]
