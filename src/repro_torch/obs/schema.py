"""The documented stats schemas — the contract dashboards build on.

``RetrievalService.stats`` / ``index_stats()`` / ``CompactionDriver.
stats()`` are consumed by the BENCH emitters, the CI assert blocks,
and any scraping dashboard; a silently renamed key breaks all of them
after merge instead of in review.  These frozensets are asserted
exact (``==``, not ``<=``) by ``tests/test_obs.py`` /
``tests/test_serve.py``: adding a key is a deliberate, reviewed edit
here, in the producer, and in docs/observability.md together.
"""
from __future__ import annotations

__all__ = ["RETRIEVAL_SERVICE_KEYS", "COMPACTION_STATS_KEYS",
           "INDEX_STATS_KEYS", "ENGINE_STATS_KEYS",
           "SHARDED_INDEX_EXTRA_KEYS",
           "DRIVER_STATS_KEYS", "SCHEDULER_STATS_KEYS",
           "SCHEDULER_TENANT_KEYS", "CACHE_STATS_KEYS",
           "COLLECTION_STATS_KEYS", "COLLECTION_MANAGER_KEYS",
           "CHECKPOINT_STATS_KEYS", "WORK_PHASE_KEYS",
           "EVENT_BASE_FIELDS", "retrieval_stats_keys"]

# RetrievalService's own serving counters (before the index_stats
# merge); "scheduler", "cache", and "collections" are sub-dicts pinned
# below (the collections sub-dict is present unconditionally — empty
# manager, stable schema)
RETRIEVAL_SERVICE_KEYS = frozenset({
    "queries", "linear_served", "frac_linear",
    "compaction_ticks", "idle_ticks", "index_size",
    "scheduler", "cache", "collections"})

# ShapeBucketScheduler.stats() — the coalescing/admission view;
# "tenants" is the per-collection sub-dict pinned below
SCHEDULER_STATS_KEYS = frozenset({
    "queue_depth", "submits", "rejects", "batches", "requests_batched",
    "ticks", "queue_wait_sum_s", "queue_wait_max_s",
    "max_batch", "max_wait_s", "max_queue", "tenants"})

# stats["scheduler"]["tenants"][<collection>] — one tenant's
# token-bucket + drain view
SCHEDULER_TENANT_KEYS = frozenset({
    "submits", "rejects", "batched", "queue_depth", "tokens",
    "rate", "burst", "weight", "queue_wait_max_s"})

# ResultCache.stats() — the version-keyed result cache view
CACHE_STATS_KEYS = frozenset({
    "hits", "misses", "puts", "evictions", "stale_drops",
    "entries", "bytes", "max_bytes", "hit_rate"})

# CompactionStats.as_dict() — shared by both streaming indexes
COMPACTION_STATS_KEYS = frozenset({
    "compactions", "freezes", "last_reason", "last_seconds",
    "total_seconds", "rows_dropped", "rows_frozen", "rows_moved",
    "compact_steps", "last_merge_steps", "merges_per_level",
    "rows_merged_per_level"})

# DynamicHybridIndex.index_stats() (sharded adds the extras below)
INDEX_STATS_KEYS = frozenset({
    "n_live", "n_main", "n_main_dead", "delta_count", "delta_live",
    "delta_capacity", "segments", "levels", "pending_merges",
    "inserts", "deletes", "work_seconds"}) | COMPACTION_STATS_KEYS

# the port's index_stats() beyond the reference's keys: the query
# engine's counters (QueryEngine.stats), the last build's seconds and, of
# the streaming indexes, how query batches met the delta (the last two);
# HybridLSHIndex.index_stats() has only the first two, and
# RetrievalService.stats leaves them all out, so its keys stay the
# reference's
ENGINE_STATS_KEYS = frozenset({"query", "build_seconds",
                               "delta_kernel_batches", "delta_empty_batches"})

SHARDED_INDEX_EXTRA_KEYS = frozenset({
    "shards", "level_n_pads", "live_per_shard", "delta_per_shard",
    "shard_skew", "placement", "routing"})

# CompactionDriver.stats() — index-derived fields aggregate over the
# attached collection pool; "fairness" maps collection -> worker ops
DRIVER_STATS_KEYS = frozenset({
    "worker_alive", "pending_gathers", "staged_rows", "staged_ready",
    "budget_rows", "stage_calls", "prepares", "drains", "applied",
    "flushes", "cuts", "worker_errors", "collections", "fairness",
    "work_seconds"})

# CheckpointManager.stats() — the incremental-snapshot ledger:
# chunks/bytes written vs reused (content-address hit rate), GC and
# litter-sweep counts, and the last save/restore wall times
CHECKPOINT_STATS_KEYS = frozenset({
    "saves", "incremental_saves", "chunks_written", "chunks_reused",
    "bytes_written", "bytes_reused", "chunks_gced", "litter_swept",
    "steps_kept", "last_save_seconds", "last_restore_seconds"})

# CollectionManager.stats()["collections"][<name>] — one tenant's view
COLLECTION_STATS_KEYS = frozenset({
    "n_live", "version", "segments", "pending_merges", "delta_live",
    "queries", "linear_served", "inserts", "deletes",
    "quota_rate", "quota_burst", "quota_weight"})

# CollectionManager.stats() top level
COLLECTION_MANAGER_KEYS = frozenset({
    "n_collections", "created_total", "dropped_total", "collections"})

# WorkPhases.as_dict() — the compaction work-seconds sub-dict
WORK_PHASE_KEYS = frozenset({"stage", "build", "apply", "full", "total"})

# every EventLog entry carries at least these
EVENT_BASE_FIELDS = frozenset({"seq", "ts", "kind"})


def retrieval_stats_keys(*, sharded: bool = False,
                         driver: bool = False) -> frozenset:
    """Exact key set of ``RetrievalService.stats`` for a configuration."""
    keys = RETRIEVAL_SERVICE_KEYS | INDEX_STATS_KEYS
    if sharded:
        keys |= SHARDED_INDEX_EXTRA_KEYS
    if driver:
        keys |= {"driver"}
    return keys
