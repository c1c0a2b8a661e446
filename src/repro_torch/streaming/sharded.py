"""ShardedDynamicHybridIndex — the streaming index over a ``ShardMesh``.

Every shard of the mesh owns a full level stack worth of segment state,
on its own device:

  * levels — a list of frozen segments shared *structurally* across
             shards: every shard holds its own rows for level entry k,
             padded to one common ``n_pad`` so that a saved level is a
             stack of (S, ...) leaves.  Pad rows are hashed to bucket
             ``B`` (one past the bucket space), which the CSR sums and
             the HLL max drop exactly: padding costs capacity, never
             correctness.  HLLs are keyed on per-level globally-unique
             internal ids (shard * n_pad + row), so a ``pmax`` of merged
             registers per level is the exact distinct-union sketch across
             shards; levels are disjoint document sets, so their
             estimates sum (the engine's N-segment combination).
  * tomb   — per-(shard, level) live bitmap + per-(table, bucket) dead
             counts (the engine's tombstone correction terms).
  * delta  — per-shard fixed-capacity delta segment; inserts and deletes
             are the single-host index's scatters, per shard, in place.

When the deltas fill, every shard's live delta rows freeze in place into
one new level-0 entry (no cross-shard movement, no rehash: the delta
carries its hashes).  A tiered ``CompactionPolicy`` merges a level's
entries into the next level; merges are staged in bounded
``compact_step(budget_rows)`` increments (a host gather of at most
``budget_rows`` rows a step across shards) and the merged level swaps in
atomically, so queries are served from the old level list until then.

A merge is also the one point rows *move between shards*: the staged
survivors are on the host anyway, so at swap time a ``PlacementPolicy``
(``keep_local`` / ``round_robin`` / ``load_balance``;
``streaming.compaction``) assigns each surviving row a target shard and
``_make_level`` rewrites the ``_loc`` entry of every placed row.  The
mid-merge delete re-check runs *before* placement, so a row deleted while
staged is dropped, never moved.

Queries: per shard, the engine's segments (a ``TableSegment`` per level
and the ``DeltaView``) give their terms through one
``QueryEngine.segment_terms`` (K3's terms mode, one launch a shard); one
``psum`` / ``pmax`` round a level merges them across shards;
``finalize_route`` prices the global and each shard's local terms, and
the routing policy (``"global"`` or the density-adaptive
``"per_shard"``) or ``force`` picks each shard's route, taken on the host
(the reference's ``lax.cond``).  ``QueryEngine.search_group`` searches
the route and ``compact_results`` fills each shard's (Q, max_out) buffer.
Reported ids are external; after any churn, mid-merge included, the
reported sets equal a fresh single-host build's on the surviving corpus,
per route.

``state_dict()`` has the reference's keys, dtypes and stacked (S, ...)
leaves, so either package loads the other's state; a different shard
count re-deals the live rows (the elastic restore).
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.manager import array_digest, host_copy
from repro_torch.core.cost_model import CostModel
from repro_torch.core.distributed import (ShardMesh, prefers_lsh,
                                          stack_shards)
from repro_torch.core.engine import (QueryEngine, SegmentEstimate,
                                     TableSegment, _pad_size,
                                     compact_results, finalize_route)
from repro_torch.core.index import as_rows
from repro_torch.core.lsh.families import bucket_fn_for
from repro_torch.core.lsh.tables import LSHTables, build_tables
from repro_torch.interop import params_from_numpy, tables_from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels.ref import unit_rows
from repro_torch.obs import Observability
from repro_torch.obs.metrics import WorkPhases, time_block
from repro_torch.streaming import delta as delta_lib
from repro_torch.streaming import tombstones as tomb_lib
from repro_torch.streaming.compaction import (CompactionPolicy,
                                              CompactionStats,
                                              PlacementPolicy,
                                              make_placement_policy)
from repro_torch.streaming.segment import (FrozenSegment, MainSegment,
                                           _hash_rows, mark_rows_dead,
                                           rows_to_numpy)

__all__ = ["ShardedDynamicHybridIndex", "ShardedQueryResult"]

# the six build-time leaves of a level; only live / tomb_counts change
# after construction, so their digests can be cached
_IMMUTABLE_LEAVES = ("x", "ids", "bucket_ids", "perm", "starts", "registers")


def _np(a) -> np.ndarray:
    """A leaf of a state (numpy, or a tensor on any device) as numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


@dataclasses.dataclass
class ShardedQueryResult:
    """Union-over-shards reporting buffers + routing diagnostics.

    The buffers stay tensors on the mesh's first device; ``neighbors``
    and ``reported`` read host copies made once, on first use."""

    ids: torch.Tensor         # (S, Q, max_out) external doc ids
    dists: torch.Tensor       # (S, Q, max_out)
    mask: torch.Tensor        # (S, Q, max_out) reported r-near neighbors
    collisions: torch.Tensor  # (Q,) global live collisions
    cand_est: torch.Tensor    # (Q,) global corrected candSize estimate
    used_lsh: np.ndarray      # (S,) per-shard strategy decision
    n_queries: int

    @functools.cached_property
    def _host(self):
        return tuple(t.cpu().numpy() for t in (self.ids, self.dists,
                                               self.mask))

    def neighbors(self, i: int) -> np.ndarray:
        ids, _, mask = self._host
        return ids[:, i][mask[:, i]]

    def reported(self, i: int):
        """(ids, dists) reported for query ``i``, flattened over shards."""
        ids, dists, mask = self._host
        m = mask[:, i]
        return ids[:, i][m], dists[:, i][m]

    def neighbor_sets(self):
        return {i: set(self.neighbors(i).tolist())
                for i in range(self.n_queries)}

    @property
    def frac_linear(self) -> float:
        return float((~self.used_lsh).mean())

    @property
    def n_linear(self) -> int:
        """Queries served by linear search, scaled by the shard vote:
        sharded routing is per (batch, shard), so the single-host index's
        exact per-query count degenerates to the shard fraction here."""
        return round(self.n_queries * self.frac_linear)


@dataclasses.dataclass
class _ShardLevel:
    """One level entry: each shard's frozen segment, on its device.

    Every part has ``n_pad`` rows; ``parts[s].n_rows`` / ``.n_live`` are
    shard s's real and live rows (the reference's ``rows_s`` /
    ``live_s``)."""

    uid: int
    level: int
    n_pad: int
    parts: List[FrozenSegment]
    # content addresses of the stacked immutable leaves, cached by
    # state_digests(): deletes rebind only live / tomb_counts
    digests: Optional[Dict[str, str]] = None

    @property
    def rows_s(self) -> np.ndarray:
        return np.asarray([p.n_rows for p in self.parts], np.int64)

    @property
    def live_s(self) -> np.ndarray:
        return np.asarray([p.n_live for p in self.parts], np.int64)

    @property
    def n_rows(self) -> int:
        return int(self.rows_s.sum())

    @property
    def n_live(self) -> int:
        return int(self.live_s.sum())

    def leaf(self, name: str) -> List[torch.Tensor]:
        """Shard by shard, the state_dict leaf ``name``."""
        get = {"x": lambda p: p.seg.x, "ids": lambda p: p.seg.ids,
               "bucket_ids": lambda p: p.seg.bucket_ids,
               "perm": lambda p: p.seg.tables.perm,
               "starts": lambda p: p.seg.tables.starts,
               "registers": lambda p: p.seg.tables.registers,
               "live": lambda p: p.tomb.live,
               "tomb_counts": lambda p: p.tomb.counts}[name]
        return [get(p) for p in self.parts]


def _stacked(tensors: Sequence[torch.Tensor], rows: bool = False) -> np.ndarray:
    """Per-shard tensors as one (S, ...) host array (rows as the
    reference stores them: packed codes as uint32)."""
    return np.stack([rows_to_numpy(t) if rows else host_copy(t)
                     for t in tensors])


@dataclasses.dataclass
class _ShardMergeTask:
    """A scheduled levels merge with per-(uid, shard) host staging."""

    uids: List[int]
    target_level: int
    reason: str
    shards: int
    # staging chunks: (uid, shard, row indices), rows, ids, hashes
    src: List[Tuple[int, int, np.ndarray]] = dataclasses.field(
        default_factory=list)
    rows: List[np.ndarray] = dataclasses.field(default_factory=list)
    ids: List[np.ndarray] = dataclasses.field(default_factory=list)
    bids: List[np.ndarray] = dataclasses.field(default_factory=list)
    pair_idx: int = 0       # cursor over (uid, shard) pairs
    row_off: int = 0
    steps: int = 0
    work_seconds: float = 0.0   # sum of this task's step durations

    @property
    def pairs(self) -> List[Tuple[int, int]]:
        return [(u, s) for u in self.uids for s in range(self.shards)]

    @property
    def staged_done(self) -> bool:
        return self.pair_idx >= len(self.uids) * self.shards


class ShardedDynamicHybridIndex:
    """Streaming Hybrid LSH index, row-sharded over a ``ShardMesh``."""

    def __init__(self, family, *, num_buckets: int, mesh: ShardMesh,
                 m: int = 64, cap: int = 64, delta_capacity: int = 1024,
                 cost_model: CostModel = CostModel(alpha=1.0, beta=10.0),
                 policy: CompactionPolicy = CompactionPolicy(),
                 placement: "str | PlacementPolicy" = "keep_local",
                 routing: str = "per_shard", max_out: int = 512,
                 data_axis: str = "data",
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 seed: torch.Generator | int = 0,
                 impl: Optional[str] = None,
                 obs: Optional[Observability] = None,
                 engine: Optional[QueryEngine] = None):
        """Args:
          family: LSH family (``make_family``); owns metric + hashes.
          num_buckets: buckets per table B; rows hash into [0, B), pad
            rows to B.
          mesh: a ``ShardMesh`` (``make_mesh``); shard s lives on
            ``mesh.devices[s]``.
          m: HLL registers per bucket.
          cap: LSH candidate verification cap per (query, table).
          delta_capacity: per-shard delta slots before a freeze.
          cost_model: Algorithm 2 cost constants (alpha, beta).
          policy: when to freeze / merge (``CompactionPolicy``).
          placement: merge-time row placement across shards:
            ``"keep_local"`` (rows never move), ``"round_robin"``,
            ``"load_balance"``, or any ``PlacementPolicy`` instance.
          routing: ``"global"`` (one strategy for the batch) or
            ``"per_shard"`` (each shard votes with its local estimate).
          max_out: reported neighbors per (shard, query).
          data_axis: the mesh axis rows are sharded over.
          params: family parameters (a dict of tensors, e.g. the
            reference's draws through ``repro_torch.interop``); else drawn
            from ``seed`` (a ``torch.Generator`` or an int; the
            reference's ``key``).
          impl: kernel impl override (``"ref"`` or ``"cuda"``).
          obs: observability bundle: events + work phases (per-query
            tracing needs the single-host index).
          engine: a shared ``QueryEngine``; default builds a private one.
        """
        if routing not in ("global", "per_shard"):
            raise ValueError(f"routing must be 'global' or 'per_shard', "
                             f"got {routing!r}")
        self.mesh = mesh
        self.data_axis = data_axis
        self.shards = int(mesh.shape[data_axis])
        self.devices = mesh.devices
        home = self.devices[0]
        if params is None:
            gen = seed
            if not isinstance(gen, torch.Generator):
                gen = torch.Generator().manual_seed(int(seed))
            params = family.init(gen, device=home)
        self.family = family
        self._set_params(params)
        self.num_buckets = int(num_buckets)
        self.m = int(m)
        self.cap = int(cap)
        self.delta_capacity = int(delta_capacity)
        self.cost_model = cost_model
        self.policy = policy
        self.placement = make_placement_policy(placement)
        self.routing = routing
        self.max_out = int(max_out)
        self.impl = impl
        self._engine = engine if engine is not None else QueryEngine(
            cost_model, impl=impl)
        self._bucket_fn = bucket_fn_for(family, self.num_buckets, impl)
        self.stats = CompactionStats()
        self.obs = obs if obs is not None else Observability.disabled()
        self.phases = WorkPhases("stage", "build", "apply", "full")
        # Result-cache invalidation: monotonic mutation version, bumped on
        # every insert, delete, freeze, merge swap (rebalancing included),
        # full compaction and restore.
        self._version = 0
        self._levels: List[_ShardLevel] = []
        self._delta: Optional[List[delta_lib.DeltaSegment]] = None
        self._tasks: List[_ShardMergeTask] = []
        self._next_uid = 0
        self._d: Optional[int] = None            # row width
        self._dtype: Optional[torch.dtype] = None
        # host bookkeeping: ext -> (shard, "m", uid, row) | (shard, "d", slot)
        self._loc: Dict[int, tuple] = {}
        self._next_id = 0
        self._delta_count_s = np.zeros(self.shards, np.int64)
        self._delta_live_s = np.zeros(self.shards, np.int64)
        self._inserts = 0
        self._deletes = 0
        self._delta_kernel_batches = self._delta_empty_batches = 0

    def _set_params(self, params: Dict[str, torch.Tensor]) -> None:
        """The family parameters, one copy per distinct shard device."""
        self._params_at = {dev: {k: v.to(dev) for k, v in params.items()}
                           for dev in dict.fromkeys(self.devices)}
        self.params = self._params_at[self.devices[0]]

    def _unit_rows_on(self, dev: torch.device) -> bool:
        """Cosine on the kernel route keeps each segment's unit rows."""
        return (self.family.metric == "cosine"
                and ops.resolve_impl(self.impl, dev) == "cuda")

    # ------------------------------------------------------------- sizes
    @property
    def n(self) -> int:
        return (sum(l.n_live for l in self._levels)
                + int(self._delta_live_s.sum()))

    @property
    def n_frozen_rows(self) -> int:
        return sum(l.n_rows for l in self._levels)

    @property
    def n_dead(self) -> int:
        return sum(l.n_rows - l.n_live for l in self._levels)

    @property
    def version(self) -> int:
        """Monotonic mutation version (the result-cache key component):
        changes whenever a query could report differently."""
        return self._version

    def _next_uid_(self) -> int:
        u = self._next_uid
        self._next_uid += 1
        return u

    def _rows(self, x) -> torch.Tensor:
        return as_rows(x, self.family.metric, self.devices[0])

    # ------------------------------------------------------------- build
    def build(self, x, ids: Optional[Sequence[int]] = None
              ) -> "ShardedDynamicHybridIndex":
        """Initial batch build; returns self.

        ``x`` (n, d) corpus rows, dealt round-robin over shards; ``ids``
        optional (n,) unique external ids (default 0..n-1).  Replaces any
        existing state."""
        x = self._rows(x)
        n = int(x.shape[0])
        if ids is None:
            ids = np.arange(n, dtype=np.int64)
        else:
            ids = np.asarray(ids, np.int64)
            if len(set(ids.tolist())) != len(ids):
                raise ValueError("duplicate ids")
        self._d, self._dtype = int(x.shape[1]), x.dtype
        S = self.shards
        self._levels = []
        self._tasks = []
        self._loc = {}
        self._version += 1
        if n:
            self._make_level([(x[s::S], ids[s::S]) for s in range(S)],
                             self.policy.level_for(n, self.delta_capacity))
        self._reset_delta()
        self._next_id = int(ids.max()) + 1 if n else 0
        return self

    def _make_level(self, parts: List[tuple], level: int) -> _ShardLevel:
        """Per-shard (rows, ext ids[, bucket rows]) -> one padded level.

        With bucket rows (freezes and merges) the build runs from the
        staged hashes; without, it hashes the rows.  Rows and hashes may
        be tensors or numpy; each part lands on its shard's device."""
        L, B = self.family.L, self.num_buckets
        ks = [len(p[1]) for p in parts]
        n_pad = _pad_size(max(max(ks), 1))
        uid = self._next_uid_()
        segs = []
        for s, (dev, p, k) in enumerate(zip(self.devices, parts, ks)):
            x = torch.zeros((n_pad, self._d), dtype=self._dtype, device=dev)
            ext = torch.full((n_pad,), -1, dtype=torch.int32, device=dev)
            valid = torch.zeros((n_pad,), dtype=torch.bool, device=dev)
            if k:
                x[:k] = as_rows(p[0], self.family.metric, dev)
                ext[:k] = torch.from_numpy(
                    np.asarray(p[1]).astype(np.int32)).to(dev)
                valid[:k] = True
            if len(p) == 3:
                bids = torch.full((n_pad, L), B, dtype=torch.int32,
                                  device=dev)
                if k:
                    bids[:k] = torch.as_tensor(p[2]).to(dev, torch.int32)
            else:
                bids = _hash_rows(self._bucket_fn, self._params_at[dev], x)
            # pad rows hash to bucket B: dropped by the CSR sums and the
            # HLL max, invisible to every estimate
            bids = torch.where(valid[:, None], bids, torch.full_like(bids, B))
            gids = s * n_pad + torch.arange(n_pad, dtype=torch.int32,
                                            device=dev)
            t = build_tables(gids, bids, B, self.m)
            live = torch.cat([valid, torch.zeros((1,), dtype=torch.bool,
                                                 device=dev)])
            segs.append(FrozenSegment(
                uid=uid, level=int(level),
                seg=MainSegment(
                    x=x, ids=ext, bucket_ids=bids,
                    tables=LSHTables(t.perm - s * n_pad, t.starts,
                                     t.registers),
                    x_unit=(unit_rows(x).contiguous()
                            if self._unit_rows_on(dev) else None)),
                tomb=tomb_lib.Tombstones(live=live, counts=torch.zeros(
                    (L, B), dtype=torch.int32, device=dev)),
                n_rows=k, n_live=k))
        lvl = _ShardLevel(uid=uid, level=int(level), n_pad=n_pad, parts=segs)
        self._levels.append(lvl)
        self._version += 1
        for s, p in enumerate(parts):
            for i, e in enumerate(np.asarray(p[1]).tolist()):
                self._loc[int(e)] = (s, "m", uid, i)
        return lvl

    def _reset_delta(self) -> None:
        self._delta = [delta_lib.make_delta(self.delta_capacity, self._d,
                                            self.family.L, self._dtype, dev)
                       for dev in self.devices]
        self._delta_count_s[:] = 0
        self._delta_live_s[:] = 0

    def _ensure_init(self, rows: torch.Tensor) -> None:
        """First contact without build(): no levels, delta-only shards."""
        if self._delta is not None:
            return
        self._d, self._dtype = int(rows.shape[1]), rows.dtype
        self._levels = []
        self._reset_delta()

    # ------------------------------------------------------------ insert
    def insert(self, rows, ids: Optional[Sequence[int]] = None,
               shard: Optional[int] = None) -> np.ndarray:
        """Append documents to the shard deltas; returns their external
        ids as (k,) int64.

        ``ids``: optional (k,) unused external ids, default continuing
        the running counter.  ``shard`` pins the whole batch to one
        shard's delta (key-hash placement: how skewed streams arise);
        default None water-fills the least-loaded deltas.  The batch is
        split by the remaining per-shard delta capacity, freezing every
        shard's delta into a new level-0 entry when the target shard(s)
        fill."""
        rows = self._rows(rows)
        if rows.shape[0] == 0:
            return np.zeros((0,), np.int64)
        if shard is not None and not 0 <= int(shard) < self.shards:
            raise ValueError(f"shard {shard} not in [0, {self.shards})")
        self._ensure_init(rows)
        if ids is None:
            ids = np.arange(self._next_id, self._next_id + rows.shape[0],
                            dtype=np.int64)
        else:
            ids = np.asarray(ids, np.int64)
            if len(set(ids.tolist())) != len(ids):
                raise KeyError("duplicate ids within insert batch")
        for e in ids.tolist():
            if e in self._loc:
                raise KeyError(f"id {e} already indexed")
        lo = 0
        while lo < rows.shape[0]:
            free = self.delta_capacity - self._delta_count_s
            if shard is not None:
                # pinned: only the target shard's capacity counts
                pin = np.zeros_like(free)
                pin[int(shard)] = free[int(shard)]
                free = pin
            if free.sum() == 0:
                self._freeze("delta_full")
                continue
            take = int(min(free.sum(), rows.shape[0] - lo))
            # round-robin water-fill over shards with free slots
            order = np.argsort(self._delta_count_s, kind="stable")
            assign: List[List[int]] = [[] for _ in range(self.shards)]
            left, cursor = take, 0
            while left:
                s = (int(shard) if shard is not None
                     else int(order[cursor % self.shards]))
                cursor += 1
                if free[s] > len(assign[s]):
                    assign[s].append(lo + take - left)
                    left -= 1
            self._insert_chunk(rows, ids, assign)
            lo += take
        self._next_id = max(self._next_id, int(ids.max()) + 1)
        self._maybe_compact()
        return ids

    def _insert_chunk(self, rows: torch.Tensor, ids: np.ndarray,
                      assign: List[List[int]]) -> None:
        """One padded scatter per shard, every shard: the reference's
        fused ``.at[]`` insert under ``shard_map`` pads each shard's
        batch to one power of two, and its pad lanes (a zero row, id 0)
        land on every shard's trash row, which this keeps as it does."""
        pk = _pad_size(max(max(len(a) for a in assign), 1))
        for s, (dev, idxs) in enumerate(zip(self.devices, assign)):
            k = len(idxs)
            rows_p = torch.zeros((pk, self._d), dtype=self._dtype, device=dev)
            ids_p = np.zeros(pk, np.int32)
            valid = np.zeros(pk, bool)
            if k:
                sel = torch.as_tensor(idxs, dtype=torch.int64,
                                      device=rows.device)
                rows_p[:k] = rows[sel].to(dev)
                ids_p[:k] = ids[idxs]
                valid[:k] = True
            base = int(self._delta_count_s[s])
            delta_lib.insert(self._delta[s], rows_p,
                             self._bucket_fn(self._params_at[dev], rows_p),
                             torch.from_numpy(ids_p).to(dev),
                             torch.from_numpy(valid).to(dev))
            for i, j in enumerate(idxs):
                self._loc[int(ids[j])] = (s, "d", base + i)
            self._delta_count_s[s] += k
            self._delta_live_s[s] += k
            self._inserts += k
        self._version += 1

    # ------------------------------------------------------------ delete
    def delete(self, ids: Iterable[int], strict: bool = False) -> int:
        """Tombstone documents by external id; returns #removed.

        Unknown (or already-deleted) ids are skipped unless ``strict``
        (KeyError).  Deletes mark per-(shard, level) live bitmaps and
        bump per-bucket dead counts; tables are never mutated, and a row
        staged in a pending merge is dropped at swap time."""
        S = self.shards
        by_uid: Dict[int, List[List[int]]] = {}
        delta_slots: List[List[int]] = [[] for _ in range(S)]
        for e in ids:
            loc = self._loc.pop(int(e), None)
            if loc is None:
                if strict:
                    raise KeyError(e)
                continue
            s, kind = loc[0], loc[1]
            if kind == "d":
                delta_slots[s].append(loc[2])
            else:
                by_uid.setdefault(loc[2],
                                  [[] for _ in range(S)])[s].append(loc[3])
        removed = 0
        for uid, main_rows in by_uid.items():
            lvl = self._level_by_uid(uid)
            for part, rr in zip(lvl.parts, main_rows):
                mark_rows_dead(part, rr)
                removed += len(rr)
        for s, (dev, slots) in enumerate(zip(self.devices, delta_slots)):
            if slots:
                delta_lib.kill(self._delta[s],
                               torch.tensor(slots, dtype=torch.int64,
                                            device=dev),
                               torch.ones(len(slots), dtype=torch.bool,
                                          device=dev))
                self._delta_live_s[s] -= len(slots)
                removed += len(slots)
        self._deletes += removed
        if removed:
            self._version += 1
        self._maybe_compact()
        return removed

    def _level_by_uid(self, uid: int) -> _ShardLevel:
        for l in self._levels:
            if l.uid == uid:
                return l
        raise KeyError(uid)

    # --------------------------------------------------------- compaction
    def _delta_live_rows(self, s: int):
        """(x, ext ids as int64 numpy, bucket ids) of shard s's live delta
        rows, on its device."""
        d, C = self._delta[s], self.delta_capacity
        live = d.live[:C]
        return (d.x[:C][live], host_copy(d.ids[:C][live]).astype(np.int64),
                d.bucket_ids[:C][live])

    def _freeze(self, reason: str) -> None:
        """Seal every shard's live delta rows into one level-0 entry.

        Rows stay on their shard; the delta already carries its hashes,
        so the freeze is one build from hashes over at most
        delta_capacity rows per shard."""
        if self._delta is None or self._delta_count_s.sum() == 0:
            return
        parts = [self._delta_live_rows(s) for s in range(self.shards)]
        total = sum(len(p[1]) for p in parts)
        self._reset_delta()
        if total == 0:
            return
        self._make_level(parts, level=0)
        self.stats.record_freeze(total)
        self.obs.events.emit("freeze", rows=total, reason=reason)

    def _maybe_compact(self) -> None:
        if self._delta is not None:
            r = self.policy.freeze_reason(
                delta_count=int(self._delta_count_s.max()),
                delta_capacity=self.delta_capacity)
            if r:
                self._freeze(r)
        self._schedule_merges()
        if self.policy.step_rows is None:
            self._drain()

    def _pending_uids(self) -> set:
        return {u for t in self._tasks for u in t.uids}

    def _schedule_merges(self) -> None:
        if not self._levels:
            return
        pend = self._pending_uids()
        free = [l for l in self._levels if l.uid not in pend]
        counts: Dict[int, int] = {}
        for l in free:
            counts[l.level] = counts.get(l.level, 0) + 1
        for reason, src, target in self.policy.plan_merges(
                level_counts=counts, n_rows=self.n_frozen_rows,
                n_dead=self.n_dead,
                n_live=sum(l.n_live for l in self._levels),
                unit=self.delta_capacity, can_full=not pend):
            uids = [l.uid for l in free if src is None or l.level == src]
            if uids:
                self._tasks.append(_ShardMergeTask(
                    uids=uids, target_level=target,
                    reason=reason, shards=self.shards))
                self.obs.events.emit("merge_scheduled", uids=uids,
                                     target_level=target, reason=reason)

    @property
    def has_compaction_work(self) -> bool:
        return bool(self._tasks)

    @property
    def staged_ready(self) -> bool:
        """A fully-staged merge awaits a control-thread ``apply_staged``."""
        return bool(self._tasks) and self._tasks[0].staged_done

    @property
    def staged_rows(self) -> int:
        """Rows currently gathered into merge staging buffers."""
        return sum(sum(len(r) for r in t.rows) for t in self._tasks)

    @property
    def pending_merges(self) -> int:
        """Queued merge tasks (the head may be partly staged)."""
        return len(self._tasks)

    def _budget(self, budget_rows: Optional[int]) -> int:
        return int(budget_rows or self.policy.step_rows
                   or max(self.delta_capacity, 1))

    def stage_step(self, budget_rows: Optional[int] = None) -> str:
        """Advance ONLY the staging half of the active merge (the
        ``CompactionDriver`` worker's half): gather at most
        ``budget_rows`` live rows across shards into private host
        buffers.  The served level list is untouched.  Returns
        ``"idle"`` | ``"staging"`` | ``"ready"``."""
        if not self._tasks:
            return "idle"
        task = self._tasks[0]
        if task.staged_done:
            return "ready"
        task.steps += 1
        self.stats.record_step()
        with time_block(phases=self.phases, phase="stage") as tb:
            self._stage(task, self._budget(budget_rows))
        task.work_seconds += tb.elapsed
        return "ready" if task.staged_done else "staging"

    def prepare_staged(self) -> bool:
        """No-op on the sharded index (returns False): the placement
        policy partitions the staged rows by the per-shard live loads *at
        swap time*, so the build cannot run early."""
        return False

    def apply_staged(self) -> bool:
        """CONTROL-THREAD ONLY: swap a fully-staged merge in (delete
        re-check, placement, build, level swap with its ``_loc``
        rewrites, cascade).  Returns True when a merge was applied."""
        if not self._tasks or not self._tasks[0].staged_done:
            return False
        task = self._tasks[0]
        task.steps += 1
        self.stats.record_step()
        self._apply(task)
        return True

    def compact_step(self, budget_rows: Optional[int] = None) -> bool:
        """Advance the active merge by one bounded step (a gather of at
        most ``budget_rows`` rows across shards, or, once staging is
        complete, the build and atomic level swap).  Returns True while
        more work remains."""
        if not self._tasks:
            return False
        task = self._tasks[0]
        task.steps += 1
        self.stats.record_step()
        if not task.staged_done:
            with time_block(phases=self.phases, phase="stage") as tb:
                self._stage(task, self._budget(budget_rows))
            task.work_seconds += tb.elapsed
            if not task.staged_done:
                return True
        self._apply(task)
        return bool(self._tasks)

    def _apply(self, task: _ShardMergeTask) -> None:
        with time_block(phases=self.phases, phase="apply") as tb:
            total, dropped, moved = self._finalize_merge(task)
        task.work_seconds += tb.elapsed
        self.stats.record_merge(task.target_level, total, task.steps,
                                task.work_seconds, dropped,
                                reason=task.reason, moved=moved)
        self.obs.events.emit("swap", target_level=task.target_level,
                             rows=total, dropped=dropped, steps=task.steps,
                             seconds=task.work_seconds, reason=task.reason)
        if moved:
            self.obs.events.emit("rebalance", rows_moved=moved,
                                 target_level=task.target_level,
                                 placement=self.placement.name)
        self._schedule_merges()       # cascade up the levels

    def _stage(self, task: _ShardMergeTask, budget: int) -> None:
        pairs = task.pairs
        left = max(budget, 1)
        while left > 0 and not task.staged_done:
            uid, s = pairs[task.pair_idx]
            part = self._level_by_uid(uid).parts[s]
            if task.row_off >= part.n_rows:
                task.pair_idx += 1
                task.row_off = 0
                continue
            lo = task.row_off
            hi = min(part.n_rows, lo + left)
            live = host_copy(part.tomb.live[lo:hi])
            idx = np.arange(lo, hi)[live]
            if len(idx):
                task.src.append((uid, s, idx))
                task.rows.append(host_copy(part.seg.x[lo:hi])[live])
                task.ids.append(host_copy(part.seg.ids[lo:hi])[live])
                task.bids.append(host_copy(part.seg.bucket_ids[lo:hi])[live])
            left -= hi - lo
            task.row_off = hi

    def _finalize_merge(self, task: _ShardMergeTask) -> Tuple[int, int, int]:
        """Swap the staged merge in; returns (rows kept, dropped, moved).

        Order matters: (1) re-check every staged row against the
        *current* live bitmap, so deletes that landed mid-merge do not
        resurrect; (2) hand the survivors (with their origin shards) to
        the placement policy; (3) re-partition them by target shard and
        build the new level, whose ``_make_level`` rewrites ``_loc`` for
        every row, moved rows included."""
        S = self.shards
        lives: Dict[Tuple[int, int], np.ndarray] = {}
        surv: List[tuple] = []   # (origin shard, rows, ids, bids)
        for (uid, s, idx), rows, ids, bids in zip(task.src, task.rows,
                                                  task.ids, task.bids):
            if (uid, s) not in lives:
                lives[uid, s] = host_copy(
                    self._level_by_uid(uid).parts[s].tomb.live)
            live = lives[uid, s][idx]
            if live.any():
                surv.append((s, rows[live], ids[live].astype(np.int64),
                             bids[live]))
        total_in = sum(self._level_by_uid(u).n_rows for u in task.uids)
        self._tasks.pop(0)
        self._levels = [l for l in self._levels if l.uid not in task.uids]
        self._version += 1
        if not surv:
            return 0, total_in, 0
        origins = np.concatenate(
            [np.full(len(c[2]), c[0], np.int64) for c in surv])
        xs = np.concatenate([c[1] for c in surv], axis=0)
        es = np.concatenate([c[2] for c in surv])
        bs = np.concatenate([c[3] for c in surv], axis=0)
        # base load: live rows per shard outside this merge (the surviving
        # levels and the delta); the merged levels are already dropped
        targets = np.asarray(
            self.placement.assign(origins, self.shard_loads(), S), np.int64)
        # a faulty custom policy must fail the merge loudly, not drop
        # rows whose _loc entries would then dangle
        if targets.shape != origins.shape or not (
                (0 <= targets) & (targets < S)).all():
            raise ValueError(
                f"placement policy {self.placement.name!r} returned bad "
                f"targets (shape {targets.shape}, expected "
                f"{origins.shape}, values must be in [0, {S}))")
        moved = int((targets != origins).sum())
        self._make_level([(xs[targets == s], es[targets == s],
                           bs[targets == s]) for s in range(S)],
                         level=task.target_level)
        return len(es), total_in - len(es), moved

    def _drain(self) -> None:
        while self._tasks:
            self.compact_step(budget_rows=max(self.n_frozen_rows, 1))

    def compact(self, reason: str = "manual") -> None:
        """Blocking full compaction: fold every level and the delta into
        one level, each shard's rows staying on it (drops tombstones).
        Pending merge staging is discarded, not drained."""
        t0 = time.perf_counter()
        if self._delta is None:
            return
        self._tasks = []
        dropped = self.n_dead + int(
            (self._delta_count_s - self._delta_live_s).sum())
        parts, total = [], 0
        for s in range(self.shards):
            dx, de, db = self._delta_live_rows(s)
            xs, es, bs = [dx], [de], [db]
            for lvl in self._levels:
                p = lvl.parts[s]
                live = p.tomb.live[:lvl.n_pad]
                xs.append(p.seg.x[live])
                es.append(host_copy(p.seg.ids[live]).astype(np.int64))
                bs.append(p.seg.bucket_ids[live])
            parts.append((torch.cat(xs), np.concatenate(es), torch.cat(bs)))
            total += len(parts[-1][1])
        self._levels = []
        self._version += 1
        self._reset_delta()
        if total:
            self._make_level(parts, self.policy.level_for(
                total, self.delta_capacity))
        self.stats.record(reason, t0, dropped)
        self.phases.add("full", self.stats.last_seconds)
        self.obs.events.emit("full_compact", reason=reason, dropped=dropped,
                             seconds=self.stats.last_seconds)

    # ------------------------------------------------------------- query
    def _segments(self, s: int) -> List:
        """Shard s's level stack + delta as engine ``Segment`` adapters."""
        metric = self.family.metric
        segs: List = []
        for lvl in self._levels:
            p = lvl.parts[s]
            segs.append(TableSegment(
                tables=p.seg.tables, x=p.seg.x, metric=metric, cap=self.cap,
                impl=self.impl, live=p.tomb.live, tomb_counts=p.tomb.counts,
                ext_ids=p.seg.ids, n_live=p.n_live, n_scan=lvl.n_pad,
                x_unit=p.seg.x_unit))
        segs.append(delta_lib.DeltaView(
            self._delta[s], metric, impl=self.impl,
            n_live=int(self._delta_live_s[s]),
            n_scan=int(self._delta_count_s[s])))
        return segs

    def query(self, queries, r: float,
              force: Optional[str] = None) -> ShardedQueryResult:
        """Hybrid r-NN reporting, union over shards; ids are external.

        Args:
          queries: (Q, d) rows, replicated to every shard.
          r: report radius; every returned neighbor has dist <= r.
          force: None (hybrid routing) | "lsh" | "linear" override.

        Returns a ``ShardedQueryResult`` with (S, Q, max_out) reporting
        buffers (``neighbors(i)`` flattens the shard axis) and the global
        routing diagnostics."""
        if self._delta is None:
            raise RuntimeError("index is empty: build/insert first")
        out = self._query(queries, r, force)
        self._delta_empty_batches += bool((self._delta_count_s == 0).any())
        self._delta_kernel_batches += out.n_queries > 0 and any(
            n and ops.resolve_impl(self.impl, dev) == "cuda"
            for n, dev in zip(self._delta_count_s, self.devices))
        return out

    def _query(self, queries, r: float,
               force: Optional[str]) -> ShardedQueryResult:
        S, mesh, cm = self.shards, self.mesh, self.cost_model
        n_pads = [l.n_pad for l in self._levels]
        C = self.delta_capacity
        # both routes fill one buffer: clamp by the narrower one's width
        max_out = min(self.max_out, sum(n_pads) + C + 1,
                      len(n_pads) * self.family.L * self.cap + C + 1)
        hashed = {}
        segs, local = [], []
        for s, dev in enumerate(self.devices):
            if dev not in hashed:
                q = as_rows(queries, self.family.metric, dev)
                hashed[dev] = (q, self._bucket_fn(self._params_at[dev], q))
            segs.append(self._segments(s))
            local.append(self._engine.segment_terms(segs[-1],
                                                    hashed[dev][1]))
        # cross-shard merge, level by level: psum the exact terms, pmax
        # the registers (each level's internal ids are globally unique and
        # levels are disjoint doc sets, so pmax a level + sum across
        # levels is exact); the delta's exact counts sum
        merged = []
        for k in range(len(self._levels)):
            merged.append(SegmentEstimate(
                collisions=mesh.psum([t[k].collisions for t in local])[0],
                dead_collisions=mesh.psum(
                    [t[k].dead_collisions for t in local])[0],
                merged_registers=mesh.pmax(
                    [t[k].merged_registers for t in local])[0]))
        merged.append(SegmentEstimate(
            collisions=mesh.psum([t[-1].collisions for t in local])[0],
            cand_exact=mesh.psum([t[-1].cand_exact.to(torch.float32)
                                  for t in local])[0]))
        n_live_s = self.shard_loads()
        n_scan_s = self._delta_count_s + sum(n_pads)
        route_g = finalize_route(merged, cm, n_live=int(n_live_s.sum()),
                                 n_scan=int(n_scan_s.sum()))
        nq = int(queries.shape[0])
        if force in ("lsh", "linear"):
            used = [force == "lsh"] * S
        elif self.routing == "global":
            used = [prefers_lsh(route_g, nq)] * S
        else:
            used = [prefers_lsh(finalize_route(
                local[s], cm, n_live=int(n_live_s[s]),
                n_scan=int(n_scan_s[s])), nq) for s in range(S)]
        out = []
        for s, dev in enumerate(self.devices):
            q, qb = hashed[dev]
            out.append(compact_results(*self._engine.search_group(
                segs[s], qb, q, float(r), lsh_route=used[s]), max_out))
        ids, dists, mask = stack_shards(mesh, out)
        return ShardedQueryResult(ids=ids, dists=dists, mask=mask,
                                  collisions=route_g.collisions,
                                  cand_est=route_g.cand_est,
                                  used_lsh=np.asarray(used, bool),
                                  n_queries=nq)

    # ------------------------------------------------------ observability
    def shard_of(self, ext_id: int) -> int:
        """Shard currently holding a live document (KeyError if absent);
        stable only until the next merge, which may move the row."""
        return self._loc[int(ext_id)][0]

    def validate_locations(self) -> int:
        """Debug invariant check: every ``_loc`` entry resolves to a live
        row whose stored external id matches, and every live row is
        reachable.  Returns the live rows checked; raises AssertionError
        on any inconsistency.  Host-side and O(n): for tests and
        debugging, not the serving path."""
        by_uid = {l.uid: (l, [host_copy(p.tomb.live) for p in l.parts],
                          [host_copy(p.seg.ids) for p in l.parts])
                  for l in self._levels}
        d_live = [host_copy(d.live) for d in self._delta or []]
        d_ids = [host_copy(d.ids) for d in self._delta or []]
        n_checked = 0
        for e, loc in self._loc.items():
            s, kind = loc[0], loc[1]
            if kind == "m":
                uid, row = loc[2], loc[3]
                entry = by_uid.get(uid)
                assert entry is not None, (e, loc, "level gone")
                lvl, live, ids = entry
                assert row < lvl.parts[s].n_rows, (e, loc, "row out of range")
                assert bool(live[s][row]), (e, loc, "dead row")
                assert int(ids[s][row]) == e, (e, loc, "id mismatch")
            else:
                slot = loc[2]
                assert bool(d_live[s][slot]), (e, loc, "dead")
                assert int(d_ids[s][slot]) == e, (e, loc, "id mismatch")
            n_checked += 1
        assert n_checked == self.n, (n_checked, self.n)
        return n_checked

    def shard_loads(self) -> np.ndarray:
        """(S,) live rows per shard (levels + delta)."""
        loads = self._delta_live_s.copy()
        for l in self._levels:
            loads += l.live_s
        return loads

    def index_stats(self) -> Dict[str, object]:
        """Size / level / compaction counters (host ints and lists), with
        the sharded extras: per-shard live and delta loads,
        ``placement``, ``rows_moved`` (cumulative rows rebalanced at
        merges), ``shard_skew`` = max / mean live load (1.0 is
        balanced; keep_local under a skewed stream grows it toward S) and
        how query batches met the deltas: ``delta_kernel_batches``, those
        in which some shard's delta held rows on the collision test
        kernel's route, and ``delta_empty_batches``, those in which some
        shard's delta held none."""
        live_per_shard = np.zeros(self.shards, np.int64)
        for l in self._levels:
            live_per_shard += l.live_s
        loads = live_per_shard + self._delta_live_s
        skew = float(loads.max() / loads.mean()) if loads.sum() else 1.0
        levels: Dict[int, int] = {}
        for l in self._levels:
            levels[l.level] = levels.get(l.level, 0) + 1
        out = {
            "n_live": self.n,
            "n_main": self.n_frozen_rows,
            "n_main_dead": self.n_dead,
            "delta_count": int(self._delta_count_s.sum()),
            "delta_live": int(self._delta_live_s.sum()),
            "delta_capacity": self.delta_capacity,
            "shards": self.shards,
            "segments": len(self._levels),
            "levels": levels,
            "level_n_pads": [l.n_pad for l in self._levels],
            "pending_merges": len(self._tasks),
            "live_per_shard": live_per_shard.tolist(),
            "delta_per_shard": self._delta_count_s.tolist(),
            "shard_skew": skew,
            "placement": self.placement.name,
            "routing": self.routing,
            "inserts": self._inserts,
            "deletes": self._deletes,
            "work_seconds": self.compaction_work_seconds,
            "delta_kernel_batches": self._delta_kernel_batches,
            "delta_empty_batches": self._delta_empty_batches,
        }
        out.update(self.stats.as_dict())
        return out

    @property
    def compaction_work_seconds(self) -> Dict[str, float]:
        """Per-phase compaction work (stage / build / apply / full +
        total), the accumulator the driver's ``stats()`` reports too."""
        return self.phases.as_dict()

    # -------------------------------------------------------- checkpoint
    def state_dict(self) -> Dict[str, Dict[str, np.ndarray]]:
        """Level stack + deltas as nested host arrays with the reference's
        keys, dtypes and leading shard axis (packed codes as uint32), so
        either package loads the other's.  Staged merge progress is
        volatile: a pending merge's inputs are still complete levels.
        Per-shard ``rows_s`` / ``live_s`` ride in each level's meta and
        the placement policy's name in the top-level meta."""
        S, L = self.shards, self.family.L
        levels: Dict[str, Dict] = {}
        for i, l in enumerate(self._levels):
            levels[f"{i:04d}"] = {
                **{k: _stacked(l.leaf(k), rows=k == "x")
                   for k in ("x", "ids", "bucket_ids", "perm", "starts",
                             "registers", "live", "tomb_counts")},
                "meta": {"uid": np.int64(l.uid),
                         "level": np.int64(l.level),
                         "rows_s": l.rows_s, "live_s": l.live_s},
            }
        if self._delta is not None:
            ds = self._delta
            delta = {"x": _stacked([d.x for d in ds], rows=True),
                     "bucket_ids": _stacked([d.bucket_ids for d in ds]),
                     "ids": _stacked([d.ids for d in ds]),
                     "live": _stacked([d.live for d in ds]),
                     "count": np.asarray([d.count for d in ds], np.int32)}
        else:
            C = self.delta_capacity
            delta = {"x": np.zeros((S, C + 1, 0), np.float32),
                     "bucket_ids": np.full((S, C + 1, L), -1, np.int32),
                     "ids": np.full((S, C + 1), -1, np.int32),
                     "live": np.zeros((S, C + 1), bool),
                     "count": np.zeros((S,), np.int32)}
        return {
            "params": {k: host_copy(v) for k, v in self.params.items()},
            "levels": levels,
            "delta": delta,
            "meta": {"next_id": np.int64(self._next_id),
                     "built": np.int64(0 if self._delta is None else 1),
                     "next_uid": np.int64(self._next_uid),
                     # 0-d unicode array: np.save round-trips it, and a
                     # restored index keeps rebalancing the same way
                     "placement": np.array(self.placement.name)},
        }

    def state_digests(self) -> Dict[str, str]:
        """Content addresses of the immutable (stacked) level leaves, for
        ``CheckpointManager.save_incremental``; cached on each level, and
        equal to the reference's for equal state."""
        out: Dict[str, str] = {}
        for i, l in enumerate(self._levels):
            if l.digests is None:
                l.digests = {k: array_digest(_stacked(l.leaf(k),
                                                      rows=k == "x"))
                             for k in _IMMUTABLE_LEAVES}
            for k, dg in l.digests.items():
                out[f"levels/{i:04d}/{k}"] = dg
        return out

    def load_state_dict(self, state) -> "ShardedDynamicHybridIndex":
        """Restore state saved by ``state_dict`` (this package's or the
        reference's; leaves numpy or tensors).  A saved shard count other
        than the mesh's routes through ``_load_elastic``, which re-deals
        the live rows onto the current shards."""
        self._set_params(params_from_numpy(
            {k: _np(v) for k, v in state["params"].items()},
            self.devices[0]))
        self._tasks = []
        self._version += 1
        meta = state["meta"]
        self._next_id = int(_np(meta["next_id"]))
        self._next_uid = int(_np(meta.get("next_uid", 0)))
        pl = meta.get("placement")
        if pl is not None:      # pre-rebalancing states keep the ctor's
            try:
                self.placement = make_placement_policy(str(_np(pl)))
            except ValueError:
                # a custom PlacementPolicy: only its name is saved, so the
                # constructor's policy stays
                pass
        self._loc = {}
        self._levels = []
        if int(_np(meta["built"])) == 0:
            self._delta = None
            return self
        ds = {k: _np(v) for k, v in state["delta"].items()}
        self.delta_capacity = int(ds["live"].shape[1]) - 1
        self._d = int(ds["x"].shape[2])
        lvls = {k: dict(v) for k, v in (state.get("levels") or {}).items()}
        ms = state.get("main")
        if ms is not None and _np(ms["x"]).shape[1] > 0:
            # pre-stack format (one sharded "main", no meta): one level
            ms = {k: _np(v) for k, v in ms.items()}
            rows_s = (ms["ids"] != -1).sum(axis=1).astype(np.int64)
            lvls["main"] = {**ms, "meta": {
                "uid": np.int64(0),
                "level": np.int64(self.policy.level_for(
                    int(rows_s.sum()), self.delta_capacity)),
                "rows_s": rows_s,
                "live_s": ms["live"][:, :ms["x"].shape[1]].sum(
                    axis=1).astype(np.int64)}}
        S_saved = int(ds["live"].shape[0])
        if S_saved != self.shards:
            return self._load_elastic(lvls, ds, S_saved)
        metric = self.family.metric
        for key in sorted(lvls):
            s = {k: (v if k == "meta" else _np(v))
                 for k, v in lvls[key].items()}
            meta_l = s["meta"]
            uid = int(_np(meta_l["uid"]))
            level = int(_np(meta_l["level"]))
            rows_s = _np(meta_l["rows_s"]).astype(np.int64)
            live_s = _np(meta_l["live_s"]).astype(np.int64)
            n_pad = int(s["x"].shape[1])
            parts = []
            for sh, dev in enumerate(self.devices):
                x = as_rows(np.array(s["x"][sh]), metric, dev)
                parts.append(FrozenSegment(
                    uid=uid, level=level,
                    seg=MainSegment(
                        x=x, ids=_i32(s["ids"][sh], dev),
                        bucket_ids=_i32(s["bucket_ids"][sh], dev),
                        tables=tables_from_numpy(s["perm"][sh],
                                                 s["starts"][sh],
                                                 s["registers"][sh], dev),
                        x_unit=(unit_rows(x).contiguous()
                                if self._unit_rows_on(dev) else None)),
                    tomb=tomb_lib.Tombstones(
                        live=_flag(s["live"][sh], dev),
                        counts=_i32(s["tomb_counts"][sh], dev)),
                    n_rows=int(rows_s[sh]), n_live=int(live_s[sh])))
                for i in np.nonzero(s["live"][sh, :n_pad])[0]:
                    self._loc[int(s["ids"][sh, i])] = (sh, "m", uid, int(i))
            self._levels.append(_ShardLevel(uid=uid, level=level,
                                            n_pad=n_pad, parts=parts))
        self._next_uid = max(self._next_uid, max(
            [l.uid for l in self._levels], default=-1) + 1)
        C = self.delta_capacity
        self._delta = []
        for sh, dev in enumerate(self.devices):
            x = as_rows(np.array(ds["x"][sh]), metric, dev)
            self._delta.append(delta_lib.DeltaSegment(
                x=x, bucket_ids=_i32(ds["bucket_ids"][sh], dev),
                ids=_i32(ds["ids"][sh], dev), live=_flag(ds["live"][sh], dev),
                count=int(ds["count"][sh])))
            for i in range(int(ds["count"][sh])):
                if ds["live"][sh, i]:
                    self._loc[int(ds["ids"][sh, i])] = (sh, "d", int(i))
        self._dtype = self._delta[0].x.dtype
        self._delta_count_s = ds["count"].astype(np.int64)
        self._delta_live_s = ds["live"][:, :C].sum(axis=1).astype(np.int64)
        return self

    def _load_elastic(self, lvls: Dict[str, Dict], ds: Dict[str, np.ndarray],
                      S_saved: int) -> "ShardedDynamicHybridIndex":
        """Restore a state saved on a different shard count.

        Each saved level's live rows, with their staged hashes, are
        gathered across the saved shards and dealt round-robin onto the
        current ones through ``_make_level`` (no re-hash): the row
        movement a rebalancing merge makes, which leaves the reported
        sets as they were.  Dead rows drop as the next merge would drop
        them.  Delta rows re-deal the same way; if the current shards'
        deltas cannot hold them, they freeze into a level first."""
        S, L, C = self.shards, self.family.L, self.delta_capacity
        self._dtype = as_rows(ds["x"][0, :1], self.family.metric, "cpu").dtype

        def live_rows(x, ids, bids, live):
            return tuple(np.concatenate([a[sh][live[sh]]
                                         for sh in range(S_saved)])
                         for a in (x, ids, bids))

        for key in sorted(lvls):
            s = lvls[key]
            n_pad = int(_np(s["x"]).shape[1])
            gx, gi, gb = live_rows(_np(s["x"]), _np(s["ids"]),
                                   _np(s["bucket_ids"]),
                                   _np(s["live"])[:, :n_pad])
            if gi.shape[0] == 0:
                continue        # a fully-dead level: a merge drops it
            self._make_level(
                [(gx[sh::S], gi[sh::S], gb[sh::S]) for sh in range(S)],
                int(_np(s["meta"]["level"])))
        count = ds["count"].astype(np.int64)
        used = np.arange(C + 1)[None, :] < count[:, None]
        rx, ri, rb = live_rows(ds["x"], ds["ids"], ds["bucket_ids"],
                               ds["live"] & used)
        if rx.shape[0] > S * C:
            self._make_level([(rx[sh::S], ri[sh::S], rb[sh::S])
                              for sh in range(S)], 0)
            rx, ri, rb = rx[:0], ri[:0], rb[:0]
        self._reset_delta()
        for sh, dev in enumerate(self.devices):
            px, pi, pb = rx[sh::S], ri[sh::S], rb[sh::S]
            k = px.shape[0]
            d = self._delta[sh]
            if k:
                d.x[:k] = as_rows(px, self.family.metric, dev)
                d.bucket_ids[:k] = torch.from_numpy(
                    np.asarray(pb, np.int32)).to(dev)
                d.ids[:k] = torch.from_numpy(np.asarray(pi, np.int32)).to(dev)
                d.live[:k] = True
            d.count = k
            self._delta_count_s[sh] = k
            self._delta_live_s[sh] = k
            for i, e in enumerate(pi.tolist()):
                self._loc[int(e)] = (sh, "d", int(i))
        return self


def _i32(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.int32)).to(dev)


def _flag(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a, bool)).to(dev)
