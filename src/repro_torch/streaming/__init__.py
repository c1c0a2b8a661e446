"""Streaming index subsystem: incremental inserts/deletes over the
static Hybrid LSH core.

  * ``DynamicHybridIndex``  — delta segment + multi-level LSM segment
                              stack + tombstones, with tiered, budgeted
                              off-query-path compaction
  * ``streaming.delta``     — fixed-capacity append-only delta segment
                              (+ its engine ``DeltaView`` adapter)
  * ``streaming.tombstones``— per-segment tombstone bitmap + per-bucket
                              dead counts (the engine's correction term)
  * ``streaming.segment``   — frozen segments, freeze (Algorithm 1 over
                              a padded block) and the ``SegmentStack``
                              with incremental ``compact_step`` merges
  * ``streaming.compaction``— tiered trigger policy + per-level stats
  * ``streaming.driver``    — ``CompactionDriver``: merge staging on a
                              background worker thread, swaps handed
                              back to the control thread via ``drain()``
  * ``ShardedDynamicHybridIndex`` — the same index row-sharded over a
                              ``core.distributed.ShardMesh``, with
                              merge-time placement across shards
"""
from repro_torch.streaming.compaction import (CompactionPolicy,
                                              CompactionStats,
                                              KeepLocalPlacement,
                                              LoadBalancePlacement,
                                              PlacementPolicy,
                                              RoundRobinPlacement,
                                              make_placement_policy)
from repro_torch.streaming.delta import DeltaSegment, DeltaView, make_delta
from repro_torch.streaming.driver import CompactionDriver
from repro_torch.streaming.index import DynamicHybridIndex
from repro_torch.streaming.sharded import (ShardedDynamicHybridIndex,
                                           ShardedQueryResult)
from repro_torch.streaming.segment import (FrozenSegment, MainSegment,
                                           SegmentStack, build_main,
                                           freeze_segment)
from repro_torch.streaming.tombstones import Tombstones, make_tombstones

__all__ = ["DynamicHybridIndex", "ShardedDynamicHybridIndex",
           "ShardedQueryResult", "CompactionDriver",
           "CompactionPolicy", "CompactionStats",
           "PlacementPolicy", "KeepLocalPlacement", "RoundRobinPlacement",
           "LoadBalancePlacement", "make_placement_policy",
           "DeltaSegment", "DeltaView", "make_delta", "MainSegment",
           "FrozenSegment", "SegmentStack", "build_main", "freeze_segment",
           "Tombstones", "make_tombstones"]
