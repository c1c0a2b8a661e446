"""Tiered compaction policy, merge-time placement, per-level bookkeeping.

The streaming index keeps its frozen segments in an LSM-style level
stack (``streaming.segment.SegmentStack``).  Three kinds of maintenance
work exist, and this module decides when each runs:

  * freeze  — the fixed-capacity delta is (nearly) full; its live rows
              are sealed into an immutable level-0 minor segment through
              the ``build_tables`` fusion.  O(delta_capacity), cheap.
  * merge   — a level holds >= ``fanout`` segments; they fuse into one
              segment at the next level.  Each row is merged O(log n)
              times over its lifetime instead of once per delta fill.
  * full    — the global tombstone ratio crossed ``tombstone_ratio``;
              every frozen segment merges into one, dropping dead rows.

Merges are *scheduled*, not run inline: the index materializes them as
merge-task work items whose gather cost is paid in bounded
``compact_step(budget_rows)`` increments off the query path.  With
``step_rows=None`` the index drains scheduled merges synchronously
(the simple single-host default); the serving layer sets ``step_rows``
and either interleaves ticks between query batches or — fully async —
hands the staging half to a ``streaming.driver.CompactionDriver``
worker thread, keeping only the atomic swap on the control thread
(docs/compaction.md walks the whole lifecycle).

Thread-safety: ``CompactionPolicy`` is frozen/stateless — safe from
any thread.  ``CompactionStats`` is written from the control thread
except ``record_step``, which the driver's worker also calls per
staging gather; it is a bare counter increment (GIL-atomic), and every
other mutation (``record_merge``, ``record_freeze``, ``record``) stays
control-thread-only, so ``as_dict()`` snapshots are always coherent.

For the mesh-sharded index a merge is also the one moment rows can
*move between shards* (the surviving rows sit in host-side staging
buffers anyway).  ``PlacementPolicy`` decides each surviving row's
target shard at swap time:

  * ``keep_local``   — rows stay on their origin shard (zero
                       movement, skew persists forever)
  * ``round_robin``  — rows are dealt over shards in order, ignoring
                       current load (cheap, eventually-even)
  * ``load_balance`` — water-fill against per-shard live-row counts so
                       the post-merge max shard load is minimized while
                       moving as few rows as possible

Skew matters because sharded levels pad every shard to the *max* shard's
row count (one common ``n_pad`` per level keeps the level a single
stacked leaf): a shard hoarding rows inflates every shard's padded scan,
so the per-query cost estimate — and the latency it predicts — degrades
globally, exactly the density-skew failure mode the HLL estimator
exists to detect.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

__all__ = ["CompactionPolicy", "CompactionStats", "PlacementPolicy",
           "KeepLocalPlacement", "RoundRobinPlacement",
           "LoadBalancePlacement", "make_placement_policy",
           "water_fill_counts"]


# ---------------------------------------------------------------------------
# Merge-time shard placement
# ---------------------------------------------------------------------------
def water_fill_counts(base_load: np.ndarray, k: int) -> np.ndarray:
    """Split ``k`` fungible rows over shards to minimize the max load.

    Args:
      base_load: (S,) int — live rows each shard already holds outside
        the rows being placed.
      k: number of rows to place.

    Returns (S,) int counts summing to ``k``: the classic water-fill —
    raise the lowest-loaded shards to a common level, ties broken by
    shard order (deterministic).
    """
    base = np.asarray(base_load, np.int64)
    k = int(k)
    if k <= 0:
        return np.zeros_like(base)
    lo, hi = int(base.min()), int(base.max()) + k

    def deficit(level: int) -> int:
        return int(np.maximum(0, level - base).sum())

    while lo < hi:                      # largest level with deficit <= k
        mid = (lo + hi + 1) // 2
        if deficit(mid) <= k:
            lo = mid
        else:
            hi = mid - 1
    counts = np.maximum(0, lo - base)
    rem = k - int(counts.sum())
    order = np.argsort(base + counts, kind="stable")
    counts[order[:rem]] += 1
    return counts


class PlacementPolicy:
    """Assigns each surviving row of a staged merge to a target shard.

    Subclass and override ``assign`` for custom placement; the sharded
    index calls it once per completed merge, at swap time, after the
    mid-merge delete re-check (so only truly-live rows are placed).
    ``assign`` always runs on the control thread — even under the async
    ``CompactionDriver`` the swap (and with it placement) never moves
    off-thread, because ``base_load`` must be the live per-shard loads
    at the moment of the swap.  Policies may therefore keep state
    without locking, but must not block: a slow ``assign`` stalls the
    serving thread's drain.
    """

    name = "custom"

    def assign(self, origins: np.ndarray, base_load: np.ndarray,
               shards: int) -> np.ndarray:
        """Target shard per surviving merge row.

        Args:
          origins: (k,) int — each row's current (origin) shard.
          base_load: (S,) int — per-shard live rows *outside* this merge
            (remaining levels + delta), the load the placed rows add to.
          shards: shard count S.

        Returns (k,) int targets in [0, S).
        """
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.name!r})"


class KeepLocalPlacement(PlacementPolicy):
    """Rows never leave their shard (the pre-rebalancing invariant)."""

    name = "keep_local"

    def assign(self, origins, base_load, shards):
        return np.asarray(origins, np.int64)


class RoundRobinPlacement(PlacementPolicy):
    """Deal rows over shards in order, ignoring load and origin."""

    name = "round_robin"

    def assign(self, origins, base_load, shards):
        k = len(np.asarray(origins))
        return np.arange(k, dtype=np.int64) % int(shards)


class LoadBalancePlacement(PlacementPolicy):
    """Water-fill to the per-shard quota that minimizes max live load,
    keeping rows local whenever their origin shard has quota left (so
    movement is the minimum the quota permits)."""

    name = "load_balance"

    def assign(self, origins, base_load, shards):
        origins = np.asarray(origins, np.int64)
        k = len(origins)
        quota = water_fill_counts(base_load, k)
        targets = np.empty(k, np.int64)
        leftovers: List[int] = []
        for s in range(int(shards)):
            rows_s = np.nonzero(origins == s)[0]
            take = min(len(rows_s), int(quota[s]))
            targets[rows_s[:take]] = s
            quota[s] -= take
            leftovers.extend(rows_s[take:].tolist())
        if leftovers:
            fill = np.repeat(np.arange(int(shards)), quota)
            targets[np.asarray(leftovers, np.int64)] = fill
        return targets


_PLACEMENTS = {p.name: p for p in (KeepLocalPlacement, RoundRobinPlacement,
                                   LoadBalancePlacement)}


def make_placement_policy(spec: Union[str, PlacementPolicy, None]
                          ) -> PlacementPolicy:
    """Resolve a placement spec: a policy instance passes through, a
    name (``keep_local`` / ``round_robin`` / ``load_balance``) or None
    (-> ``keep_local``) constructs the built-in."""
    if spec is None:
        return KeepLocalPlacement()
    if isinstance(spec, PlacementPolicy):
        return spec
    try:
        return _PLACEMENTS[spec]()
    except KeyError:
        raise ValueError(
            f"unknown placement policy {spec!r}; "
            f"expected one of {sorted(_PLACEMENTS)}") from None


@dataclasses.dataclass(frozen=True)
class CompactionPolicy:
    delta_fill: float = 1.0        # freeze when delta count/capacity >= this
    tombstone_ratio: float = 0.25  # full merge when dead/frozen-rows >= this
    fanout: int = 4                # merge a level when it holds >= fanout segs
    step_rows: Optional[int] = None  # None: drain merges synchronously;
    #                                  set: only budgeted compact_step() runs

    # ------------------------------------------------------------ triggers
    def freeze_reason(self, *, delta_count: int,
                      delta_capacity: int) -> Optional[str]:
        """Why the delta should freeze into a level-0 segment now."""
        if delta_capacity and delta_count / delta_capacity >= self.delta_fill:
            return "delta_full"
        return None

    def wants_full_merge(self, *, n_rows: int, n_dead: int) -> bool:
        """Global tombstone pressure: fold every level, drop dead rows."""
        return bool(n_rows) and n_dead / n_rows >= self.tombstone_ratio

    def merge_levels(self, level_counts: Dict[int, int]) -> List[int]:
        """Levels whose segment count overflowed (ascending).

        Fanout is clamped to >= 2: merging single-segment levels would
        cascade forever (every merge re-creates a one-segment level).
        """
        fanout = max(self.fanout, 2)
        return sorted(k for k, c in level_counts.items() if c >= fanout)

    def plan_merges(self, *, level_counts: Dict[int, int], n_rows: int,
                    n_dead: int, n_live: int, unit: int,
                    can_full: bool) -> List[Tuple[str, Optional[int], int]]:
        """The one merge-decision tree, shared by the single-host and
        sharded indexes: ``[(reason, source_level | None, target)]``.

        ``level_counts``/``n_*`` must already exclude segments that are
        inputs of a pending merge; ``can_full`` says no segment is
        pending (a tombstone full-merge needs every segment).  Tombstone
        pressure wins over level overflow — the full merge subsumes it.
        """
        if n_dead > 0 and can_full and self.wants_full_merge(
                n_rows=n_rows, n_dead=n_dead):
            return [("tombstones", None, self.level_for(n_live, unit))]
        return [("level_overflow", lv, lv + 1)
                for lv in self.merge_levels(level_counts)]

    def level_for(self, n_rows: int, unit: int) -> int:
        """Nominal level of a segment of ``n_rows`` built in one piece
        (``unit`` = the freeze granularity, i.e. the delta capacity)."""
        level, budget = 0, max(int(unit), 1)
        while n_rows > budget and level < 48:
            level += 1
            budget *= max(self.fanout, 2)
        return level

    # ------------------------------------------------- legacy entry point
    def reason(self, *, delta_count: int, delta_capacity: int,
               n_main: int, n_dead: int) -> Optional[str]:
        """Pre-stack trigger surface (kept for external callers)."""
        r = self.freeze_reason(delta_count=delta_count,
                               delta_capacity=delta_capacity)
        if r:
            return r
        if self.wants_full_merge(n_rows=n_main, n_dead=n_dead):
            return "tombstones"
        return None


@dataclasses.dataclass
class CompactionStats:
    """Cumulative maintenance counters, shared by both streaming
    indexes and surfaced through ``index_stats()``.

    ``steps`` counts budgeted advances — serving-thread ticks *and*
    driver-worker staging gathers (``record_step`` is the one method a
    worker thread may call; everything else is control-thread-only).
    ``record_merge``'s ``seconds`` is accumulated *work* time wherever
    it ran — under the async driver that is mostly worker time, so it
    no longer approximates serving-thread stall; the ``BENCH_async``
    bench measures that directly instead.
    """

    compactions: int = 0        # completed merges + full compactions
    freezes: int = 0            # delta -> level-0 seals
    last_reason: Optional[str] = None
    last_seconds: float = 0.0
    total_seconds: float = 0.0  # cumulative wall-clock spent compacting
    rows_dropped: int = 0       # tombstoned rows reclaimed, cumulative
    rows_frozen: int = 0
    rows_moved: int = 0         # rows rebalanced across shards at merges
    steps: int = 0              # compact_step() calls that advanced a merge
    last_merge_steps: int = 0   # steps the most recent merge took
    merges_per_level: Dict[int, int] = dataclasses.field(
        default_factory=dict)           # target level -> completed merges
    rows_merged_per_level: Dict[int, int] = dataclasses.field(
        default_factory=dict)           # target level -> rows written

    def record(self, reason: str, t0: float, dropped: int) -> None:
        self.compactions += 1
        self.last_reason = reason
        self.last_seconds = time.perf_counter() - t0
        self.total_seconds += self.last_seconds
        self.rows_dropped += int(dropped)

    def record_freeze(self, rows: int) -> None:
        self.freezes += 1
        self.rows_frozen += int(rows)

    def record_step(self) -> None:
        self.steps += 1

    def record_merge(self, level: int, rows: int, steps: int,
                     seconds: float, dropped: int,
                     reason: str = "merge", moved: int = 0) -> None:
        """``seconds`` is the merge's accumulated *work* time (the sum of
        its compact_step durations) — not schedule-to-swap wall clock,
        which under budgeted mode would count all the serving time
        interleaved between steps as time spent compacting.  ``moved``
        counts rows whose placement target differed from their origin
        shard (always 0 on single-host merges)."""
        self.compactions += 1
        self.last_reason = reason
        self.last_seconds = float(seconds)
        self.total_seconds += self.last_seconds
        self.rows_dropped += int(dropped)
        self.rows_moved += int(moved)
        self.last_merge_steps = int(steps)
        self.merges_per_level[int(level)] = (
            self.merges_per_level.get(int(level), 0) + 1)
        self.rows_merged_per_level[int(level)] = (
            self.rows_merged_per_level.get(int(level), 0) + int(rows))

    def as_dict(self) -> Dict[str, object]:
        return {"compactions": self.compactions,
                "freezes": self.freezes,
                "last_reason": self.last_reason,
                "last_seconds": self.last_seconds,
                "total_seconds": self.total_seconds,
                "rows_dropped": self.rows_dropped,
                "rows_frozen": self.rows_frozen,
                "rows_moved": self.rows_moved,
                "compact_steps": self.steps,
                "last_merge_steps": self.last_merge_steps,
                "merges_per_level": dict(self.merges_per_level),
                "rows_merged_per_level": dict(self.rows_merged_per_level)}
