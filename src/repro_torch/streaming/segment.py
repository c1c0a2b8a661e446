"""Immutable frozen segments + the multi-level LSM segment stack.

A ``FrozenSegment`` is one sealed unit of the streaming index: corpus
rows + CSR ``LSHTables`` + per-bucket HLLs (the paper's Algorithm 1
fusion) + a tombstone bitmap.  Rows are padded to a power of two and
pad rows are *hashed out of the bucket space* (bucket ``B``), which
``build_tables`` drops exactly — padding costs capacity, never
correctness.  The linear route scans the pad rows too, and is priced
at the padded size, as in the reference.

``SegmentStack`` arranges frozen segments into LSM levels:

  * level 0 holds *minor* segments sealed straight from the delta
    (``freeze``: O(delta_capacity), no rebuild of older data);
  * a tiered ``CompactionPolicy`` merges a level's segments into one
    segment at the next level when the level overflows, so each row is
    rewritten O(log n) times over its lifetime instead of once per
    delta fill.

Merges are materialized as ``MergeTask`` work items and advanced in
bounded ``compact_step(budget_rows)`` increments: each step gathers at
most ``budget_rows`` live rows (with the hashes they froze with) into
staging tensors on the device; the final step runs the fused
``build_tables`` over the staged rows and *atomically swaps* the merged
segment in (queries keep being served from the old level list until
then).  Rows deleted while staged are re-checked against the input
tombstones at swap time, so churn during a merge never resurrects dead
rows.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.manager import array_digest
from repro_torch.core.engine import _pad_size
from repro_torch.core.lsh.tables import LSHTables, build_tables
from repro_torch.kernels.ref import unit_rows as _unit_rows
from repro_torch.obs.metrics import WorkPhases, time_block
from repro_torch.streaming import tombstones as tomb_lib

__all__ = ["MainSegment", "FrozenSegment", "freeze_segment",
           "frozen_digests", "mark_rows_dead", "rows_to_numpy", "MergeTask",
           "MergeResult", "SegmentStack"]

_HASH_CHUNK = 65536


def rows_to_numpy(x: torch.Tensor) -> np.ndarray:
    """Rows as the reference stores them: float32, or packed codes as
    uint32 (the port keeps them as int32 bit views)."""
    a = x.detach().cpu().numpy()
    return a.view(np.uint32) if a.dtype == np.int32 else a


def _hash_rows(bucket_fn, params, x: torch.Tensor) -> torch.Tensor:
    return torch.cat([bucket_fn(params, x[lo:lo + _HASH_CHUNK])
                      for lo in range(0, max(x.shape[0], 1), _HASH_CHUNK)]
                     ).to(torch.int32)


@dataclasses.dataclass
class MainSegment:
    x: torch.Tensor            # (n, d) corpus rows (may include pad rows)
    ids: torch.Tensor          # (n,) int32 external doc ids (-1 on pad rows)
    bucket_ids: torch.Tensor   # (n, L) int32 per-table buckets (B on pad rows)
    tables: LSHTables
    x_unit: Optional[torch.Tensor] = None   # cosine: x's unit rows, for K1

    @property
    def n(self) -> int:
        return int(self.x.shape[0])


@dataclasses.dataclass
class FrozenSegment:
    """One immutable level entry: padded rows + tables + tombstones."""

    uid: int                # stack-unique id (stable across merges of others)
    level: int              # LSM level (0 = freshly frozen delta)
    seg: MainSegment        # n_pad rows; pads hashed out of bucket space
    tomb: tomb_lib.Tombstones
    n_rows: int             # real rows (tombstoned included, pads excluded)
    n_live: int
    # content addresses of the immutable leaves, computed lazily by
    # frozen_digests() and cached here — only tombstone state ever
    # rebinds after construction, so these stay valid for the
    # segment's lifetime
    digests: Optional[Dict[str, str]] = None

    @property
    def n_pad(self) -> int:
        return self.seg.n

    @property
    def n_dead(self) -> int:
        return self.n_rows - self.n_live


def frozen_digests(f: FrozenSegment) -> Dict[str, str]:
    """Content addresses of a frozen segment's immutable leaves, equal
    to the reference's for equal arrays (rows hashed as it stores them).

    Computed once per segment and cached on it.  The mutable leaves
    (``live``/``tomb_counts``, rebound by ``mark_rows_dead``) are
    deliberately NOT here.
    """
    if f.digests is None:
        t = f.seg.tables
        f.digests = {k: array_digest(v) for k, v in (
            ("x", rows_to_numpy(f.seg.x)), ("ids", f.seg.ids),
            ("bucket_ids", f.seg.bucket_ids), ("perm", t.perm),
            ("starts", t.starts), ("registers", t.registers))}
    return f.digests


def freeze_segment(x: torch.Tensor, ext_ids, bucket_fn, params,
                   num_buckets: int, m: int, *, uid: int, level: int,
                   bucket_rows: Optional[torch.Tensor] = None,
                   unit_rows: bool = False) -> FrozenSegment:
    """Seal rows into an immutable padded segment (Algorithm 1).

    ``x``: (k, d) rows on the segment's device; ``ext_ids``: (k,) ids.
    ``bucket_rows`` (k, L) skips re-hashing when the caller has the
    hashes already (delta freezes, merges); pad lanes always hash to
    bucket ``num_buckets`` so the fused build drops them exactly.
    ``unit_rows``: also keep x's unit rows (cosine on the kernel route,
    whose linear scan reads them), made here once per segment.
    """
    dev = x.device
    k = int(x.shape[0])
    n_pad = _pad_size(max(k, 1))
    x_p = torch.zeros((n_pad,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=dev)
    x_p[:k] = x
    ids_p = torch.full((n_pad,), -1, dtype=torch.int32, device=dev)
    ids_p[:k] = torch.as_tensor(ext_ids).to(device=dev, dtype=torch.int32)
    valid = torch.zeros((n_pad,), dtype=torch.bool, device=dev)
    valid[:k] = True
    if bucket_rows is None or k == 0:
        # an empty freeze hashes the (zero) pad rows for L
        bids = _hash_rows(bucket_fn, params, x_p)
    else:
        bids = torch.full((n_pad, bucket_rows.shape[1]), num_buckets,
                          dtype=torch.int32, device=dev)
        bids[:k] = bucket_rows
    bids = torch.where(valid[:, None], bids,
                       torch.full_like(bids, num_buckets))
    tables = build_tables(torch.arange(n_pad, dtype=torch.int32, device=dev),
                          bids, num_buckets, m)
    live = torch.cat([valid, torch.zeros((1,), dtype=torch.bool,
                                         device=dev)])
    tomb = tomb_lib.Tombstones(
        live=live, counts=torch.zeros((tables.L, num_buckets),
                                      dtype=torch.int32, device=dev))
    x_unit = (_unit_rows(x_p.to(torch.float32)).contiguous()
              if unit_rows else None)
    seg = MainSegment(x=x_p, ids=ids_p, bucket_ids=bids, tables=tables,
                      x_unit=x_unit)
    return FrozenSegment(uid=uid, level=level, seg=seg, tomb=tomb,
                         n_rows=k, n_live=k)


def mark_rows_dead(f: FrozenSegment, rows: Sequence[int]) -> None:
    """Tombstone ``rows`` of a frozen segment.

    Updates the live bitmap, the per-bucket dead counts, and ``n_live``.
    Control-thread-only (rebinds ``f.tomb``, which queries and merge
    re-checks read).  The reference pads the batch to a power of two
    for its jit cache; eager PyTorch needs no padding, and pad lanes
    added nothing there.
    """
    k = len(rows)
    if k == 0:
        return
    dev = f.seg.x.device
    rows_t = torch.as_tensor(np.asarray(rows, np.int64), device=dev)
    valid = torch.ones((k,), dtype=torch.bool, device=dev)
    f.tomb = tomb_lib.mark_dead(f.tomb, rows_t, f.seg.bucket_ids[rows_t],
                                valid)
    f.n_live -= k


# ---------------------------------------------------------------------------
# Budgeted merges
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class MergeTask:
    """A scheduled levels merge with incremental staging state."""

    uids: List[int]
    target_level: int
    reason: str
    # staging: per chunk — source (uid, row indices), rows, ids, hashes,
    # all tensors on the segments' device
    src: List[Tuple[int, torch.Tensor]] = dataclasses.field(
        default_factory=list)
    rows: List[torch.Tensor] = dataclasses.field(default_factory=list)
    ids: List[torch.Tensor] = dataclasses.field(default_factory=list)
    bids: List[torch.Tensor] = dataclasses.field(default_factory=list)
    input_idx: int = 0      # cursor: which input segment
    row_off: int = 0        # cursor: next row within it
    steps: int = 0
    work_seconds: float = 0.0   # sum of this task's compact_step durations
    # worker-side speculative build of the merged segment (uid unset,
    # -1): populated by prepare_staged() once staging completes; the
    # control-thread swap then only re-checks tombstones + rewires
    prepared: Optional["FrozenSegment"] = None

    @property
    def staged_done(self) -> bool:
        return self.input_idx >= len(self.uids)

    @property
    def staged_rows(self) -> int:
        """Live rows gathered into this task's staging buffers so far."""
        return sum(int(r.shape[0]) for r in self.rows)


@dataclasses.dataclass
class MergeResult:
    """Outcome of a completed (swapped-in) merge.

    ``dropped`` counts dead rows reclaimed (not carried into the new
    segment).  On the inline path that includes rows deleted mid-merge;
    on the prepared path (worker pre-built the segment) such rows ride
    along *tombstoned* in the new segment instead — masked from every
    query exactly like a normal delete, reclaimed at the next merge — so
    ``dropped`` there counts only rows already dead when staged.
    ``moved`` lists live rows only.
    """

    new: Optional[FrozenSegment]          # None when every row was dead
    removed_uids: List[int]
    moved: List[Tuple[int, int]]          # (ext_id, new row) pairs
    dropped: int                          # dead rows reclaimed
    steps: int
    reason: str
    seconds: float                        # accumulated step work time
    target_level: int = 0


class SegmentStack:
    """The frozen half of a streaming index: level list + merge queue.

    Owns only structure — *which* immutable segments exist, at what
    level, and what merge work is pending.  The index above it owns the
    delta, the tombstone writes, the external-id location map, and the
    decision of *when* to schedule (``CompactionPolicy``).

    Thread-safety contract (the ``CompactionDriver`` split): merge work
    divides into a *staging* half (``stage_step`` — pure reads of
    immutable segment rows into the task's private buffers) and an
    *apply* half (``apply_staged`` — mutates the level list and swaps
    the merged segment in).  Staging may run on a background worker
    thread concurrently with inserts (delta-only), deletes (tombstone
    rebinds; the swap re-checks them), freezes (list appends), and
    queries.  ``apply_staged``, ``compact_step``, and anything that
    resets the stack are control-thread-only and must be mutually
    excluded from staging — the driver's lock does exactly that.  Both
    threads enqueue their device work on PyTorch's default stream, so the
    card runs a swap after the staging it consumes.

    ``unit_rows``: every segment this stack builds keeps its unit rows
    (cosine on the kernel route).
    """

    def __init__(self, phases: Optional[WorkPhases] = None,
                 unit_rows: bool = False) -> None:
        self.segments: List[FrozenSegment] = []
        self.tasks: List[MergeTask] = []     # FIFO; tasks[0] is active
        self._next_uid = 0
        self.unit_rows = unit_rows
        # Monotonic structure version: bumped on every segment-list
        # change (freeze/add, merge swap).  The index above folds it
        # into its own ``version``.
        self.version = 0
        # Shared work-phase accumulator (the index passes its own so the
        # numbers survive stack resets): "stage" (gather), "build"
        # (speculative prepare), "apply" (swap half).
        self.phases = phases if phases is not None else WorkPhases(
            "stage", "build", "apply", "full")

    # ------------------------------------------------------------- intro
    def next_uid(self) -> int:
        """Allocate a stack-unique segment id (never reused)."""
        u = self._next_uid
        self._next_uid += 1
        return u

    def add(self, seg: FrozenSegment) -> None:
        """Append a frozen segment to the level list."""
        self.segments.append(seg)
        self.version += 1

    def by_uid(self, uid: int) -> FrozenSegment:
        """The segment with this uid; KeyError once it merged away."""
        for s in self.segments:
            if s.uid == uid:
                return s
        raise KeyError(uid)

    # ------------------------------------------------------------- sizes
    @property
    def n_rows(self) -> int:
        """Real frozen rows: tombstoned included, pad rows excluded."""
        return sum(s.n_rows for s in self.segments)

    @property
    def n_live(self) -> int:
        """Frozen rows not tombstoned."""
        return sum(s.n_live for s in self.segments)

    @property
    def n_dead(self) -> int:
        """Tombstoned frozen rows (reclaimed at the next merge)."""
        return self.n_rows - self.n_live

    def level_counts(self) -> Dict[int, int]:
        """level -> #segments, the ``CompactionPolicy`` trigger input."""
        out: Dict[int, int] = {}
        for s in self.segments:
            out[s.level] = out.get(s.level, 0) + 1
        return out

    def pending_uids(self) -> set:
        """Uids that are inputs of a queued merge (can't re-schedule)."""
        return {u for t in self.tasks for u in t.uids}

    @property
    def has_work(self) -> bool:
        """True while any merge is queued (``compact_step`` will act)."""
        return bool(self.tasks)

    @property
    def staged_ready(self) -> bool:
        """The head merge is fully staged and waits on ``apply_staged``."""
        return bool(self.tasks) and self.tasks[0].staged_done

    @property
    def staged_rows(self) -> int:
        """Rows currently held in staging buffers across queued merges."""
        return sum(t.staged_rows for t in self.tasks)

    # --------------------------------------------------------- scheduling
    def schedule(self, uids: Sequence[int], target_level: int,
                 reason: str) -> bool:
        """Queue a merge of ``uids`` unless any is already pending."""
        uids = list(uids)
        if not uids or (set(uids) & self.pending_uids()):
            return False
        self.tasks.append(MergeTask(uids=uids, target_level=target_level,
                                    reason=reason))
        return True

    # -------------------------------------------------------------- steps
    def _freeze(self, x, ids, bids, level, uid, bucket_fn, params,
                num_buckets, m) -> FrozenSegment:
        return freeze_segment(x, ids, bucket_fn, params, num_buckets, m,
                              uid=uid, level=level, bucket_rows=bids,
                              unit_rows=self.unit_rows)

    def compact_step(self, budget_rows: int, bucket_fn, params,
                     num_buckets: int, m: int) -> Optional[MergeResult]:
        """Advance the active merge by one bounded step.

        A staging step gathers at most ``budget_rows`` live rows; once
        staging is complete the *next* step runs the fused build over
        the staged rows and swaps the merged segment in.  Returns a
        ``MergeResult`` when a merge completed this step, else None.
        No-op (returns None) when nothing is queued.
        """
        if not self.tasks:
            return None
        task = self.tasks[0]
        task.steps += 1
        res = None
        if not task.staged_done:
            with time_block(phases=self.phases, phase="stage") as tb:
                self._stage(task, max(int(budget_rows), 1))
            task.work_seconds += tb.elapsed
        if task.staged_done:
            # tiny merges finish in the same step when the budget
            # covered every row — the build below is their swap
            with time_block(phases=self.phases, phase="apply") as tb:
                res = self._finalize(task, num_buckets, m, bucket_fn,
                                     params)
            task.work_seconds += tb.elapsed
        if res is not None:
            res.seconds = task.work_seconds
        return res

    def stage_step(self, budget_rows: int) -> str:
        """Advance ONLY the staging half of the head merge (no swap).

        Safe to call from a background worker thread: it reads immutable
        segment rows into the task's private buffers and never touches
        the level list.  Returns ``"idle"`` (nothing queued),
        ``"staging"`` (more gathers remain), or ``"ready"`` (staging is
        complete; a control-thread ``apply_staged`` must swap it in).
        """
        if not self.tasks:
            return "idle"
        task = self.tasks[0]
        if task.staged_done:
            return "ready"
        task.steps += 1
        with time_block(phases=self.phases, phase="stage") as tb:
            self._stage(task, max(int(budget_rows), 1))
        task.work_seconds += tb.elapsed
        return "ready" if task.staged_done else "staging"

    def prepare_staged(self, bucket_fn, params, num_buckets: int,
                       m: int) -> bool:
        """Speculatively build the head merge's output segment.

        Worker-thread-safe: once staging is complete the task's buffers
        are immutable, so the fused ``build_tables`` over them can run
        off-thread (the expensive half of a swap).  The control-thread
        ``apply_staged`` then only re-checks tombstones — rows deleted
        since staging are *marked dead in the prepared segment* rather
        than rebuilt away — assigns the uid, and swaps lists.  Returns
        True when a build ran (False: nothing staged-ready, already
        prepared, or zero staged rows — the inline path handles those).
        """
        if not self.tasks:
            return False
        task = self.tasks[0]
        if not task.staged_done or task.prepared is not None \
                or not task.rows:
            return False
        with time_block(phases=self.phases, phase="build") as tb:
            task.prepared = self._freeze(
                torch.cat(task.rows), torch.cat(task.ids),
                torch.cat(task.bids), task.target_level, -1, bucket_fn,
                params, num_buckets, m)
        task.work_seconds += tb.elapsed
        return True

    def apply_staged(self, bucket_fn, params, num_buckets: int,
                     m: int) -> Optional[MergeResult]:
        """CONTROL-THREAD ONLY: swap a fully-staged head merge in.

        Runs the mid-merge delete re-check, the fused build over the
        surviving staged rows (unless pre-built), and the atomic
        level-list swap.  Returns the ``MergeResult``, or None when no
        head merge is fully staged.
        """
        if not self.tasks or not self.tasks[0].staged_done:
            return None
        task = self.tasks[0]
        task.steps += 1
        with time_block(phases=self.phases, phase="apply") as tb:
            res = self._finalize(task, num_buckets, m, bucket_fn, params)
        task.work_seconds += tb.elapsed
        res.seconds = task.work_seconds
        return res

    def _stage(self, task: MergeTask, budget: int) -> None:
        left = budget
        while left > 0 and not task.staged_done:
            seg = self.by_uid(task.uids[task.input_idx])
            if task.row_off >= seg.n_rows:
                task.input_idx += 1
                task.row_off = 0
                continue
            lo = task.row_off
            hi = min(seg.n_rows, lo + left)
            live = seg.tomb.live[lo:hi]
            idx = torch.arange(lo, hi, device=live.device)[live]
            if idx.shape[0]:
                task.src.append((seg.uid, idx))
                task.rows.append(seg.seg.x[lo:hi][live])
                task.ids.append(seg.seg.ids[lo:hi][live])
                # rows keep the hashes they froze with (params are
                # immutable), so merges never re-hash — the budget
                # bounds a pure gather
                task.bids.append(seg.seg.bucket_ids[lo:hi][live])
            left -= hi - lo
            task.row_off = hi

    def _remove_inputs(self, task: MergeTask) -> Tuple[List[int], int]:
        total_in = sum(s.n_rows for s in self.segments
                       if s.uid in task.uids)
        self.tasks.pop(0)
        removed = list(task.uids)
        self.segments = [s for s in self.segments if s.uid not in removed]
        self.version += 1
        return removed, total_in

    def _finalize(self, task: MergeTask, num_buckets: int, m: int,
                  bucket_fn, params) -> MergeResult:
        if task.prepared is not None:
            return self._swap_prepared(task)
        # Re-check staged rows against the *current* tombstones: deletes
        # that landed mid-merge must not resurrect at swap time.
        keep_x, keep_ids, keep_bids = [], [], []
        for (uid, idx), rows, ids, bids in zip(task.src, task.rows,
                                               task.ids, task.bids):
            live = self.by_uid(uid).tomb.live[idx]
            if bool(live.any()):
                keep_x.append(rows[live])
                keep_ids.append(ids[live])
                keep_bids.append(bids[live])
        removed, total_in = self._remove_inputs(task)
        if not keep_x:
            return MergeResult(new=None, removed_uids=removed, moved=[],
                               dropped=total_in, steps=task.steps,
                               reason=task.reason,
                               seconds=task.work_seconds,
                               target_level=task.target_level)
        ids = torch.cat(keep_ids)
        new = self._freeze(torch.cat(keep_x), ids, torch.cat(keep_bids),
                           task.target_level, self.next_uid(), bucket_fn,
                           params, num_buckets, m)
        self.add(new)
        moved = [(int(e), i) for i, e in enumerate(ids.tolist())]
        return MergeResult(new=new, removed_uids=removed, moved=moved,
                           dropped=total_in - len(moved), steps=task.steps,
                           reason=task.reason, seconds=task.work_seconds,
                           target_level=task.target_level)

    def _swap_prepared(self, task: MergeTask) -> MergeResult:
        """Swap in a worker-prepared segment: the control thread's share
        is the mid-merge delete re-check (deaths since staging become
        tombstones in the new segment), the uid assignment, and the list
        swap.  No build runs here."""
        new = task.prepared
        dead_pos: List[int] = []      # new-segment rows deleted mid-merge
        moved: List[Tuple[int, int]] = []
        off = 0
        for (uid, idx), ids in zip(task.src, task.ids):
            live_now = self.by_uid(uid).tomb.live[idx].cpu().numpy()
            pos = off + np.arange(len(live_now))
            dead_pos.extend(pos[~live_now].tolist())
            moved.extend(zip(ids.cpu().numpy()[live_now].tolist(),
                             pos[live_now].tolist()))
            off += len(live_now)
        removed, total_in = self._remove_inputs(task)
        new.uid = self.next_uid()
        mark_rows_dead(new, dead_pos)
        self.add(new)
        return MergeResult(new=new, removed_uids=removed, moved=moved,
                           dropped=total_in - off, steps=task.steps,
                           reason=task.reason, seconds=task.work_seconds,
                           target_level=task.target_level)
