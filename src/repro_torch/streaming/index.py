"""DynamicHybridIndex — incremental inserts/deletes over the static core.

Segment architecture (LSM, multi-level):

  * delta segment  — fixed-capacity append-only buffers
    (``streaming.delta``), updated in place.  Counts are exact.
  * segment stack  — immutable frozen segments arranged in levels
    (``streaming.segment.SegmentStack``).  When the delta fills it is
    *frozen* into a level-0 minor segment (CSR ``LSHTables`` +
    per-bucket HLLs over just the delta rows — O(delta_capacity), the
    older data is untouched); a tiered ``CompactionPolicy`` merges a
    level into the next when it overflows.
  * tombstones     — per-segment live bitmap + per-bucket dead counts;
    deletes never mutate tables.

Merges run *off the query path*: they are staged in bounded
``compact_step(budget_rows)`` increments and the merged segment swaps
in atomically; queries are served from the old level list until then.
With ``CompactionPolicy.step_rows=None`` (default) scheduled merges
drain synchronously after each mutation; a serving layer sets
``step_rows`` and ticks ``compact_step`` between query batches, or
hands the staging to a ``CompactionDriver`` worker thread.

Queries hand the whole stack to the shared ``QueryEngine``: every frozen
segment as a tombstone-aware ``TableSegment`` (corrected estimates, dead
rows masked after search, *external* ids reported), the delta as the
exact ``DeltaView``.  A mixed insert/delete workload therefore reports
exactly the candidates a fresh ``HybridLSHIndex.build()`` on the
surviving corpus would (same family parameters, cap permitting).
``num_probes > 1`` routes the multi-probe bucket set through the same
path (SimHash only).

All state lives on ``device`` ("cuda" unless the caller asks
otherwise; there is no silent CPU fallback); host bookkeeping (the
external-id map, the delta's fill count, sizes) stays in Python.
"""
from __future__ import annotations

import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.manager import host_copy
from repro_torch.core import multiprobe as mp
from repro_torch.core.cost_model import CostModel
from repro_torch.core.engine import (QueryEngine, QueryResult, RouteEstimate,
                                     TableSegment, _pad_size)
from repro_torch.core.index import as_rows, resolve_device
from repro_torch.core.lsh.families import bucket_fn_for
from repro_torch.interop import params_from_numpy, tables_from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels.ref import unit_rows
from repro_torch.obs import Observability
from repro_torch.obs.metrics import WorkPhases
from repro_torch.obs.spans import span
from repro_torch.streaming import delta as delta_lib
from repro_torch.streaming import tombstones as tomb_lib
from repro_torch.streaming.compaction import CompactionPolicy, CompactionStats
from repro_torch.streaming.segment import (FrozenSegment, MainSegment,
                                           SegmentStack, freeze_segment,
                                           frozen_digests, mark_rows_dead,
                                           rows_to_numpy)

__all__ = ["DynamicHybridIndex"]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class DynamicHybridIndex:
    """Streaming Hybrid LSH index: insert / delete / freeze / merge / query.

    Shape conventions: corpus rows are (n, d); external ids are int64
    host-side, stored int32 on the device; per-row buckets are (n, L)
    in [0, num_buckets), with *pad rows hashed to bucket num_buckets* —
    one past the bucket space, dropped exactly by the CSR/HLL build.
    """

    def __init__(self, family, *, num_buckets: int, m: int = 64,
                 cap: int = 64, delta_capacity: int = 4096,
                 cost_model: CostModel = CostModel(alpha=1.0, beta=10.0),
                 policy: CompactionPolicy = CompactionPolicy(),
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 seed: torch.Generator | int = 0,
                 impl: Optional[str] = None,
                 obs: Optional[Observability] = None,
                 engine: Optional[QueryEngine] = None, device=None):
        """Args:
          family: LSH family (``make_family``); owns metric + hashes.
          num_buckets: buckets per table B.
          m: HLL registers per bucket.
          cap: LSH candidate verification cap per (query, table).
          delta_capacity: delta slots before a freeze.
          cost_model: Algorithm 2 cost constants (alpha, beta).
          policy: freeze/merge triggers (``CompactionPolicy``).
          params: family parameters (a dict of tensors, e.g. the
            reference's draws through ``repro_torch.interop``); else
            drawn from ``seed`` (a ``torch.Generator`` or an int).
          impl: kernel impl override (``"ref"`` or ``"cuda"``).
          obs: observability bundle (tracer + event log + registry);
            default is a fresh disabled bundle — no cost unless asked.
          engine: a shared ``QueryEngine``; default builds a private one
            from ``cost_model``.
          device: where the index lives; None means the GPU.
        """
        self.device = resolve_device(device)
        if params is None:
            gen = seed
            if not isinstance(gen, torch.Generator):
                gen = torch.Generator().manual_seed(int(seed))
            params = family.init(gen, device=self.device)
        self.family = family
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.num_buckets = int(num_buckets)
        self.m = int(m)
        self.cap = int(cap)
        self.delta_capacity = int(delta_capacity)
        self.cost_model = cost_model
        self.policy = policy
        self.impl = impl
        self.obs = obs if obs is not None else Observability.disabled()
        # Index-owned so the numbers survive stack resets
        # (build/compact/load_state_dict replace the SegmentStack).
        self.phases = WorkPhases("stage", "build", "apply", "full")
        self._engine = engine if engine is not None else QueryEngine(
            cost_model, impl=impl, tracer=self.obs.tracer)
        self._bucket_fn = bucket_fn_for(self.family, self.num_buckets, impl)
        # cosine on the kernel route: segments keep their unit rows
        self._unit_rows = (family.metric == "cosine" and ops.resolve_impl(
            impl, self.device) == "cuda")

        self.stack = self._new_stack()
        self.delta: Optional[delta_lib.DeltaSegment] = None
        self.stats = CompactionStats()
        # Result-cache invalidation: ``version`` must change whenever a
        # query could report differently.  Stack structure changes bump
        # ``stack.version``; delta inserts, deletes, and wholesale stack
        # replacements bump the base here.
        self._version_base = 0
        # Host bookkeeping: ext id -> ("m", uid, row) | ("d", slot).
        self._loc: Dict[int, tuple] = {}
        self._next_id = 0
        self._n_delta_live = 0
        self._inserts = 0
        self._deletes = 0
        self.build_seconds = 0.0   # the last build's wall seconds
        self._delta_kernel_batches = self._delta_empty_batches = 0

    def _new_stack(self) -> SegmentStack:
        return SegmentStack(phases=self.phases, unit_rows=self._unit_rows)

    # ------------------------------------------------------------- sizes
    @property
    def n(self) -> int:
        """Live document count (frozen live + delta live)."""
        return self.stack.n_live + self._n_delta_live

    @property
    def n_dead(self) -> int:
        return self.stack.n_dead

    @property
    def version(self) -> int:
        """Monotonic mutation version — the result-cache key component.

        Changes on every insert, delete, freeze, merge swap, and full
        rebuild; equal versions guarantee identical reported sets for
        the same (query, radius).
        """
        return self._version_base + self.stack.version

    def _fold_version(self) -> None:
        """Bank the current stack's version before replacing it, so the
        combined version never runs backwards."""
        self._version_base += self.stack.version + 1

    # ------------------------------------------------- compat properties
    @property
    def main(self) -> Optional[MainSegment]:
        """The sole frozen segment, when the stack holds exactly one
        (the pre-stack "main segment" view; None otherwise)."""
        if len(self.stack.segments) == 1:
            return self.stack.segments[0].seg
        return None

    @property
    def tomb(self) -> Optional[tomb_lib.Tombstones]:
        """The sole frozen segment's tombstones (None unless the stack
        holds exactly one segment)."""
        if len(self.stack.segments) == 1:
            return self.stack.segments[0].tomb
        return None

    # ------------------------------------------------------------- build
    def _rows(self, x) -> torch.Tensor:
        return as_rows(x, self.family.metric, self.device)

    def build(self, x, ids: Optional[Sequence[int]] = None
              ) -> "DynamicHybridIndex":
        """Initial batch build (Algorithm 1); returns self.

        Args: ``x`` (n, d) corpus rows; ``ids`` optional (n,) unique
        external ids (default 0..n-1).  Replaces any existing state.
        Timed on the host clock to its end on the device
        (``build_seconds``).
        """
        with span("hlsh.build"):
            t0 = time.perf_counter()
            x = self._rows(x)
            if ids is None:
                ids = np.arange(x.shape[0], dtype=np.int64)
            else:
                ids = np.asarray(ids, np.int64)
                if len(set(ids.tolist())) != len(ids):
                    raise ValueError("duplicate ids")
            self._fold_version()
            self.stack = self._new_stack()
            self._loc = {}
            if x.shape[0] > 0:
                self._add_frozen(x, ids, level=self.policy.level_for(
                    x.shape[0], self.delta_capacity))
            self._reset_delta(x.shape[1], x.dtype)
            self._next_id = int(ids.max()) + 1 if len(ids) else 0
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.build_seconds = time.perf_counter() - t0
        return self

    def _add_frozen(self, x: torch.Tensor, ext_ids: np.ndarray, level: int,
                    bucket_rows: Optional[torch.Tensor] = None
                    ) -> FrozenSegment:
        seg = freeze_segment(x, torch.from_numpy(ext_ids), self._bucket_fn,
                             self.params, self.num_buckets, self.m,
                             uid=self.stack.next_uid(), level=level,
                             bucket_rows=bucket_rows,
                             unit_rows=self._unit_rows)
        self.stack.add(seg)
        for i, e in enumerate(ext_ids.tolist()):
            self._loc[int(e)] = ("m", seg.uid, i)
        return seg

    def _reset_delta(self, d: int, dtype) -> None:
        self.delta = delta_lib.make_delta(self.delta_capacity, d,
                                          self.family.L, dtype, self.device)
        self._n_delta_live = 0

    # ------------------------------------------------------------ insert
    def insert(self, rows, ids: Optional[Sequence[int]] = None) -> np.ndarray:
        """Append documents; returns their external ids as (k,) int64.

        Args: ``rows`` (k, d); ``ids`` optional (k,) unused external ids
        (KeyError on duplicates), default continues the running counter.
        Splits the batch by remaining delta capacity, freezing the delta
        into a level-0 segment between chunks when it fills — inserts
        never wait on a rebuild of older data.
        """
        rows = self._rows(rows)
        if rows.shape[0] == 0:
            return np.zeros((0,), np.int64)
        if self.delta is None:  # first contact: empty index, delta-only
            self._reset_delta(rows.shape[1], rows.dtype)
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
            free = self.delta.capacity - self.delta.count
            if free == 0:
                self._freeze("delta_full")
                free = self.delta.capacity
            take = min(free, rows.shape[0] - lo)
            self._insert_chunk(rows[lo:lo + take], ids[lo:lo + take])
            lo += take
        self._next_id = max(self._next_id, int(ids.max()) + 1)
        self._maybe_compact()
        return ids

    def _insert_chunk(self, rows: torch.Tensor, ids: np.ndarray) -> None:
        # padded to a power of two as the reference pads it, so the
        # trash row ends up holding what it holds there
        k = rows.shape[0]
        pk = _pad_size(k)
        rows_p = torch.zeros((pk,) + tuple(rows.shape[1:]), dtype=rows.dtype,
                             device=self.device)
        rows_p[:k] = rows
        bids = self._bucket_fn(self.params, rows_p)     # (pk, L)
        ids_p = np.zeros(pk, np.int32)
        ids_p[:k] = ids
        valid = np.zeros(pk, bool)
        valid[:k] = True
        base = self.delta.count
        delta_lib.insert(self.delta, rows_p, bids,
                         torch.from_numpy(ids_p).to(self.device),
                         torch.from_numpy(valid).to(self.device))
        for i, e in enumerate(ids.tolist()):
            self._loc[int(e)] = ("d", base + i)
        self._n_delta_live += k
        self._inserts += k
        self._version_base += 1

    # ------------------------------------------------------------ delete
    def delete(self, ids: Iterable[int], strict: bool = False) -> int:
        """Tombstone documents by external id; returns #removed.

        Unknown (or already-deleted) ids are skipped unless ``strict``.
        """
        by_uid: Dict[int, List[int]] = {}
        delta_slots: List[int] = []
        for e in ids:
            loc = self._loc.pop(int(e), None)
            if loc is None:
                if strict:
                    raise KeyError(e)
                continue
            if loc[0] == "d":
                delta_slots.append(loc[1])
            else:
                by_uid.setdefault(loc[1], []).append(loc[2])
        removed = 0
        for uid, rows in by_uid.items():
            mark_rows_dead(self.stack.by_uid(uid), rows)
            removed += len(rows)
        if delta_slots:
            k = len(delta_slots)
            delta_lib.kill(self.delta,
                           torch.tensor(delta_slots, dtype=torch.int64,
                                        device=self.device),
                           torch.ones(k, dtype=torch.bool,
                                      device=self.device))
            self._n_delta_live -= k
            removed += k
        self._deletes += removed
        if removed:
            self._version_base += 1
        self._maybe_compact()
        return removed

    # --------------------------------------------------------- compaction
    def _delta_live_rows(self):
        """(x, ext ids as int64 numpy, bucket ids) of the live delta rows."""
        c = self.delta.capacity
        live = self.delta.live[:c]
        return (self.delta.x[:c][live],
                _np(self.delta.ids[:c][live]).astype(np.int64),
                self.delta.bucket_ids[:c][live])

    def _freeze(self, reason: str) -> None:
        """Seal the delta's live rows into a level-0 minor segment.

        O(delta_capacity): the delta already carries its hashes, so the
        freeze is one fused ``build_tables`` over at most capacity rows.
        """
        if self.delta is None or self.delta.count == 0:
            return
        x, ext, bids = self._delta_live_rows()
        self._reset_delta(self.delta.x.shape[1], self.delta.x.dtype)
        if len(ext) == 0:
            return
        self._add_frozen(x, ext, level=0, bucket_rows=bids)
        self.stats.record_freeze(len(ext))
        self.obs.events.emit("freeze", rows=len(ext), reason=reason)

    def _maybe_compact(self) -> None:
        if self.delta is not None:
            r = self.policy.freeze_reason(
                delta_count=self.delta.count,
                delta_capacity=self.delta_capacity)
            if r:
                self._freeze(r)
        self._schedule_merges()
        if self.policy.step_rows is None:
            self._drain()

    def _schedule_merges(self) -> None:
        """Materialize the policy's merge decisions as pending tasks."""
        segs = self.stack.segments
        if not segs:
            return
        pend = self.stack.pending_uids()
        free = [s for s in segs if s.uid not in pend]
        counts: Dict[int, int] = {}
        for s in free:
            counts[s.level] = counts.get(s.level, 0) + 1
        for reason, src, target in self.policy.plan_merges(
                level_counts=counts, n_rows=self.stack.n_rows,
                n_dead=self.stack.n_dead, n_live=self.stack.n_live,
                unit=self.delta_capacity, can_full=not pend):
            uids = [s.uid for s in free if src is None or s.level == src]
            if self.stack.schedule(uids, target, reason):
                self.obs.events.emit("merge_scheduled", uids=uids,
                                     target_level=target, reason=reason)

    def _budget(self, budget_rows: Optional[int]) -> int:
        return int(budget_rows or self.policy.step_rows
                   or max(self.delta_capacity, 1))

    def compact_step(self, budget_rows: Optional[int] = None) -> bool:
        """Advance pending merge work by one bounded step (off-query-path
        tick).  Gathers at most ``budget_rows`` rows; a merge whose
        staging is complete swaps its segment in atomically.  Returns
        True while more work remains."""
        if not self.stack.has_work:
            return False
        res = self.stack.compact_step(self._budget(budget_rows),
                                      self._bucket_fn, self.params,
                                      self.num_buckets, self.m)
        self.stats.record_step()
        if res is not None:
            self._absorb_merge(res)
        return self.stack.has_work

    def _absorb_merge(self, res) -> None:
        """Fold a completed ``MergeResult`` into index state: ``_loc``
        rewrites for every surviving row, merge stats, and the cascade
        re-schedule.  Control-thread-only."""
        if res.new is not None:
            for e, i in res.moved:
                self._loc[e] = ("m", res.new.uid, i)
        self.stats.record_merge(res.target_level, len(res.moved),
                                res.steps, res.seconds, res.dropped,
                                reason=res.reason)
        self.obs.events.emit("swap", target_level=res.target_level,
                             rows=len(res.moved), dropped=res.dropped,
                             steps=res.steps, seconds=res.seconds,
                             reason=res.reason)
        self._schedule_merges()          # cascade up the levels

    # ---------------------------------------------- driver (async) surface
    @property
    def has_compaction_work(self) -> bool:
        """True while any merge is queued."""
        return self.stack.has_work

    @property
    def staged_ready(self) -> bool:
        """A fully-staged merge awaits a control-thread ``apply_staged``."""
        return self.stack.staged_ready

    @property
    def staged_rows(self) -> int:
        """Rows currently gathered into merge staging buffers."""
        return self.stack.staged_rows

    @property
    def pending_merges(self) -> int:
        """Queued merge tasks (head may be partially staged)."""
        return len(self.stack.tasks)

    def stage_step(self, budget_rows: Optional[int] = None) -> str:
        """Advance ONLY the staging half of the active merge (the
        worker-thread half of the ``CompactionDriver`` split).  Returns
        ``"idle"`` | ``"staging"`` | ``"ready"``."""
        if not self.stack.has_work:
            return "idle"
        if self.stack.staged_ready:
            return "ready"
        st = self.stack.stage_step(self._budget(budget_rows))
        self.stats.record_step()
        return st

    def prepare_staged(self) -> bool:
        """Speculatively build the staged merge's output off-thread;
        True when a build ran."""
        return self.stack.prepare_staged(self._bucket_fn, self.params,
                                         self.num_buckets, self.m)

    def apply_staged(self) -> bool:
        """CONTROL-THREAD ONLY: swap a fully-staged merge in (delete
        re-check, atomic level swap, ``_loc`` rewrites, cascade); True
        when a merge was applied."""
        res = self.stack.apply_staged(self._bucket_fn, self.params,
                                      self.num_buckets, self.m)
        if res is None:
            return False
        self.stats.record_step()
        self._absorb_merge(res)
        return True

    def _drain(self) -> None:
        while self.stack.has_work:
            self.compact_step(budget_rows=max(self.stack.n_rows, 1))

    def compact(self, reason: str = "manual") -> None:
        """Blocking full compaction: fold every frozen segment + the
        delta into one segment (drops tombstones).  Pending merge
        staging is discarded, not drained."""
        t0 = time.perf_counter()
        self.stack.tasks = []
        if not self.stack.segments and self.delta is None:
            return
        dropped = self.stack.n_dead
        parts_x, parts_id, parts_b = [], [], []
        for f in self.stack.segments:
            live = f.tomb.live[:f.n_rows]
            parts_x.append(f.seg.x[:f.n_rows][live])
            parts_id.append(_np(f.seg.ids[:f.n_rows][live]).astype(np.int64))
            parts_b.append(f.seg.bucket_ids[:f.n_rows][live])
        if self.delta is not None:
            dropped += self.delta.count - self._n_delta_live
            x, ext, bids = self._delta_live_rows()
            parts_x.append(x)
            parts_id.append(ext)
            parts_b.append(bids)
        if not parts_x:
            return
        x = torch.cat(parts_x)
        ext = np.concatenate(parts_id)
        bids = torch.cat(parts_b)
        self._fold_version()
        self.stack = self._new_stack()
        self._loc = {}
        if len(ext):
            self._add_frozen(x, ext, level=self.policy.level_for(
                len(ext), self.delta_capacity), bucket_rows=bids)
        self._reset_delta(x.shape[1], x.dtype)
        self.stats.record(reason, t0, dropped)
        self.phases.add("full", self.stats.last_seconds)
        self.obs.events.emit("full_compact", reason=reason, dropped=dropped,
                             seconds=self.stats.last_seconds)

    # ------------------------------------------------------------- query
    def _segments(self, tidx: Optional[torch.Tensor] = None) -> List:
        """The whole stack + delta as engine ``Segment`` adapters."""
        segs: List = []
        metric = self.family.metric
        for f in self.stack.segments:
            segs.append(TableSegment(
                tables=f.seg.tables, x=f.seg.x, metric=metric,
                cap=self.cap, impl=self.impl, live=f.tomb.live,
                tomb_counts=f.tomb.counts, ext_ids=f.seg.ids,
                n_live=f.n_live, n_scan=f.n_pad, tidx=tidx,
                x_unit=f.seg.x_unit))
        segs.append(delta_lib.DeltaView(
            self.delta, metric, impl=self.impl,
            n_live=self._n_delta_live, n_scan=self.delta.count, tidx=tidx))
        return segs

    def _qbuckets(self, queries: torch.Tensor, num_probes: int
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        if num_probes > 1 and not hasattr(self.family, "margins"):
            raise ValueError(
                "multi-probe needs a family with probing sequences "
                f"(SimHash); got {type(self.family).__name__}")
        with span("hlsh.hash"):
            if num_probes <= 1:
                return self._bucket_fn(self.params, queries), None
            qbp = mp.probe_buckets(self.family, self.params, queries,
                                   num_probes, self.num_buckets, self.impl)
            return mp.flatten_probes(qbp)

    def _check_ready(self) -> None:
        if self.delta is None:
            raise RuntimeError("index is empty: build/insert first")

    def estimate(self, queries, num_probes: int = 1) -> RouteEstimate:
        self._check_ready()
        qb, tidx = self._qbuckets(self._rows(queries), num_probes)
        return self._engine.estimate(self._segments(tidx), qb)

    def query(self, queries, r: float, force: Optional[str] = None,
              num_probes: int = 1) -> QueryResult:
        """Hybrid r-NN reporting over the whole stack; ids are external.

        Args:
          queries: (Q, d) rows in the corpus metric space.
          r: report radius — every returned neighbor has dist <= r.
          force: None (hybrid) | "lsh" | "linear" strategy override.
          num_probes: > 1 probes the Lv et al. perturbation buckets in
            every frozen level AND the delta (SimHash families only).
        """
        self._check_ready()
        with span("hlsh.query"):
            q = self._rows(queries)
            qb, tidx = self._qbuckets(q, num_probes)
            self._engine.count_hash(self.family, q, self.impl)
            out = self._engine.query(self._segments(tidx), q, qb, float(r),
                                     force=force)
        n = self.delta.count
        self._delta_empty_batches += n == 0
        self._delta_kernel_batches += bool(n and q.shape[0]) and (
            ops.resolve_impl(self.impl, q.device) == "cuda")
        return out

    # ------------------------------------------------------ observability
    @property
    def compaction_work_seconds(self) -> Dict[str, float]:
        """Per-phase compaction work (stage/build/apply/full + total)."""
        return self.phases.as_dict()

    def index_stats(self) -> Dict[str, object]:
        """Size/level/compaction counters snapshot (host ints/dicts),
        with the query engine's counters under ``query``
        (``QueryEngine.stats``; an engine shared between indexes counts
        for all of them), the last build's ``build_seconds`` and how query
        batches met the delta: ``delta_kernel_batches``, those whose delta
        held rows on the collision test kernel's route, and
        ``delta_empty_batches``, those whose delta held none."""
        out = {
            "n_live": self.n,
            "n_main": self.stack.n_rows,
            "n_main_dead": self.n_dead,
            "delta_count": self.delta.count if self.delta else 0,
            "delta_live": self._n_delta_live,
            "delta_capacity": self.delta_capacity,
            "segments": len(self.stack.segments),
            "levels": self.stack.level_counts(),
            "pending_merges": len(self.stack.tasks),
            "inserts": self._inserts,
            "deletes": self._deletes,
            "work_seconds": self.compaction_work_seconds,
            "query": self._engine.stats(),
            "build_seconds": self.build_seconds,
            "delta_kernel_batches": self._delta_kernel_batches,
            "delta_empty_batches": self._delta_empty_batches,
        }
        out.update(self.stats.as_dict())
        return out

    # -------------------------------------------------------- checkpoint
    def state_dict(self) -> Dict[str, Dict[str, np.ndarray]]:
        """Stack + delta state as nested numpy arrays, with the keys and
        dtypes of the reference's ``state_dict`` (packed codes as
        uint32), so either package can load the other's.  Every leaf is
        a host copy that shares no memory with the index (the delta is
        updated in place), taken before this returns.  Staged merge
        progress is volatile: a pending merge's inputs are still
        complete segments."""
        L = self.family.L
        d = self.delta.x.shape[1] if self.delta is not None else 0
        segments: Dict[str, Dict] = {}
        for i, f in enumerate(self.stack.segments):
            t = f.seg.tables
            segments[f"{i:04d}"] = {
                "x": rows_to_numpy(f.seg.x),
                "ids": host_copy(f.seg.ids),
                "bucket_ids": host_copy(f.seg.bucket_ids),
                "perm": host_copy(t.perm),
                "starts": host_copy(t.starts),
                "registers": host_copy(t.registers),
                "live": host_copy(f.tomb.live),
                "tomb_counts": host_copy(f.tomb.counts),
                "meta": {"uid": np.int64(f.uid),
                         "level": np.int64(f.level),
                         "n_rows": np.int64(f.n_rows),
                         "n_live": np.int64(f.n_live)},
            }
        delta = (self.delta if self.delta is not None
                 else delta_lib.make_delta(self.delta_capacity, 1, L))
        return {
            "params": {k: host_copy(v) for k, v in self.params.items()},
            "segments": segments,
            "delta": {"x": rows_to_numpy(delta.x),
                      "bucket_ids": host_copy(delta.bucket_ids),
                      "ids": host_copy(delta.ids),
                      "live": host_copy(delta.live),
                      "count": np.asarray(delta.count, np.int32)},
            # delta_d == 0 marks "never populated": the saved delta row
            # width is a placeholder and must not survive a restore.
            "meta": {"next_id": np.int64(self._next_id),
                     "delta_d": np.int64(0 if self.delta is None else d),
                     "next_uid": np.int64(self.stack._next_uid)},
        }

    def state_digests(self) -> Dict[str, str]:
        """Content-address hints matching ``state_dict`` leaf paths, for
        the leaves that are immutable once frozen (equal to the
        reference's for equal state)."""
        out: Dict[str, str] = {}
        for i, f in enumerate(self.stack.segments):
            for k, dg in frozen_digests(f).items():
                out[f"segments/{i:04d}/{k}"] = dg
        return out

    def load_state_dict(self, state) -> "DynamicHybridIndex":
        """Restore stack + delta state saved by ``state_dict`` — this
        package's or the reference's (numpy, or arrays numpy can read).
        A pre-stack state (one ``"main"`` subtree, no segment meta)
        loads as one frozen segment, as in the reference."""
        dev = self.device
        self.params = params_from_numpy(
            {k: np.asarray(v) for k, v in state["params"].items()}, dev)
        self._fold_version()
        self.stack = self._new_stack()
        self._loc = {}

        def i32(a):
            return torch.from_numpy(np.array(a, np.int32)).to(dev)

        def flag(a):
            return torch.from_numpy(np.array(a, bool)).to(dev)

        segs = dict(state.get("segments") or {})
        ms = state.get("main")
        if ms is not None and np.asarray(ms["x"]).shape[0] > 0:
            # pre-stack checkpoint format (one "main" segment, exact
            # rows, no meta): migrate it to a single frozen segment —
            # ignoring it would silently restore an empty index
            n = int(np.asarray(ms["x"]).shape[0])
            segs["main"] = {
                **ms,
                "meta": {"uid": np.int64(0), "level": np.int64(
                    self.policy.level_for(n, self.delta_capacity)),
                    "n_rows": np.int64(n),
                    "n_live": np.asarray(ms["live"], bool)[:n].sum()},
            }
        for key in sorted(segs):
            s = segs[key]
            meta = s["meta"]
            x = self._rows(np.array(s["x"]))
            f = FrozenSegment(
                uid=int(np.asarray(meta["uid"])),
                level=int(np.asarray(meta["level"])),
                seg=MainSegment(
                    x=x, ids=i32(s["ids"]), bucket_ids=i32(s["bucket_ids"]),
                    tables=tables_from_numpy(s["perm"], s["starts"],
                                             s["registers"], dev),
                    x_unit=(unit_rows(x).contiguous() if self._unit_rows
                            else None)),
                tomb=tomb_lib.Tombstones(live=flag(s["live"]),
                                         counts=i32(s["tomb_counts"])),
                n_rows=int(np.asarray(meta["n_rows"])),
                n_live=int(np.asarray(meta["n_live"])))
            self.stack.add(f)
            live = np.asarray(s["live"], bool)[:f.n_rows]
            eids = np.asarray(s["ids"])[:f.n_rows]
            for i in np.nonzero(live)[0]:
                self._loc[int(eids[i])] = ("m", f.uid, int(i))
        self.stack._next_uid = int(np.asarray(
            state["meta"].get("next_uid",
                              max([s.uid for s in self.stack.segments],
                                  default=-1) + 1)))
        ds = state["delta"]
        if int(np.asarray(state["meta"].get("delta_d", 1))) == 0:
            self.delta = None        # saved before first build/insert
            self._n_delta_live = 0
        else:
            self.delta = delta_lib.DeltaSegment(
                x=self._rows(np.array(ds["x"])),
                bucket_ids=i32(ds["bucket_ids"]), ids=i32(ds["ids"]),
                live=flag(ds["live"]), count=int(np.asarray(ds["count"])))
            self.delta_capacity = self.delta.capacity
            dl = np.asarray(ds["live"], bool)
            self._n_delta_live = int(dl.sum())
            d_ids = np.asarray(ds["ids"])
            for s in range(self.delta.count):
                if dl[s]:
                    self._loc[int(d_ids[s])] = ("d", s)
        self._next_id = int(np.asarray(state["meta"]["next_id"]))
        return self
