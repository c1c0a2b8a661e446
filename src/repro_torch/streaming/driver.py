"""CompactionDriver — merge staging on a background worker thread.

The streaming index keeps merge work off the *query path*: merges advance in bounded
``compact_step(budget_rows)`` increments that the serving layer ticks
between batches.  The tick itself, though, still runs on the serving
thread — every gather of ``budget_rows`` rows is serving-thread time a
query batch could have had.  This module removes even that: a
``CompactionDriver`` owns a daemon worker thread that runs the staging
gathers (``stage_step``) continuously, while the parts that mutate
served state stay on the control thread behind a tiny handoff:

  worker thread                      control (serving) thread
  ─────────────                      ────────────────────────
  stage_step(budget) → "staging"     insert / delete / query
  stage_step(budget) → "staging"     drain()  → nothing ready, ~free
  stage_step(budget) → "ready"       insert / delete / query
  prepare_staged()  (pre-build) ──►  drain()  → apply_staged():
  (waits for the swap)                 mid-merge delete re-check,
                                       atomic level swap,
                                       PlacementPolicy + _loc rewrites,
                                       cascade scheduling
  stage_step(...)  (next merge)      drain()  → nothing ready, ~free

On the single-host index the worker also *pre-builds* the merged
segment from its immutable staging buffers (``prepare_staged``), so
the control-thread swap runs no fused build at all — rows deleted
after staging are carried as tombstones in the new segment (the same
mask a normal delete leaves) instead of forcing a rebuild.  The
sharded index cannot pre-build (its ``PlacementPolicy`` partitions
rows against swap-time live loads), so its drain pays the build; the
staging gathers — the churn-proportional half — are off-thread either
way.

The swap MUST stay on the control thread: it re-checks staged rows
against tombstones that the control thread owns, rewrites the host-side
``_loc`` map that inserts/deletes read, and (sharded) runs the
``PlacementPolicy`` against live per-shard loads — none of which can
race a mutation.  Staging, by contrast, only *reads* immutable frozen
rows into the task's private buffers, so it can overlap serving
freely; churn that lands mid-stage is caught by the swap-time re-check.

CUDA streams: both threads enqueue their device work on PyTorch's
default stream of the index's device (neither selects another stream),
so the card runs it in the order it was enqueued, and a control-thread
swap is ordered after the staging and pre-build it consumes, with no
event to wait on.

Thread-safety contract (who may call what):

  * worker thread (internal): ``index.stage_step`` under the driver
    lock.
  * control thread: ``drain`` (between batches — the scheduler's
    ``background_tick``), ``flush`` (checkpoint barrier), ``start`` /
    ``stop`` / ``notify`` / ``stats``.
  * anything that resets index state wholesale (``compact()``,
    ``build()``, ``load_state_dict()``) must not run while the worker
    is live: ``stop()`` or ``flush()`` first.  ``RetrievalService``
    does this around checkpoints and restores.

The driver works with both streaming indexes — ``DynamicHybridIndex``
and ``ShardedDynamicHybridIndex`` expose the same
``stage_step`` / ``apply_staged`` / ``has_compaction_work`` surface.
For the sharded index one worker stages all shards' chunks of the
active merge: a sharded level swap is a single cross-shard atomic
operation, so per-shard swap serialization on the control thread falls
out of the same ``drain()``.

Multi-tenant serving (docs/serving.md "Collections"): ONE driver —
one worker thread, one lock — owns every collection's index.
``attach(name, index)`` / ``detach(name)`` manage the pool; the
worker round-robins over the attached indexes that have pending merge
work, servicing ONE bounded op (a staging gather or a pre-build) per
index per turn, so a churn-heavy tenant cannot monopolize the worker
while another tenant's merge starves.  Per-collection worker-op
counts are reported as ``stats()["fairness"]``.  ``drain``/``flush``
sweep all attached indexes.  The single-index constructor form
(``CompactionDriver(index)``) attaches it under the reserved default
name ``""`` — bit-identical to the pre-collections behavior.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

__all__ = ["CompactionDriver"]


class CompactionDriver:
    """Background staging worker + control-thread swap handoff.

    Args:
      index: a streaming index (``DynamicHybridIndex`` or
        ``ShardedDynamicHybridIndex``).  The driver never outlives the
        index's state: stop/flush it before ``build``/``compact``/
        ``load_state_dict``.
      budget_rows: rows per worker staging gather (None: the index
        policy's ``step_rows``, else its delta capacity) — bounds the
        lock hold time per gather, which is the longest a control-thread
        ``drain`` can be made to wait.
      poll_s: worker sleep between idle polls; mutations can cut the
        latency with ``notify()``.

    Lifecycle: ``start()`` → serve (… ``drain()`` between batches …) →
    ``flush()`` at checkpoints → ``stop(flush=True)`` at shutdown.
    """

    def __init__(self, index=None, *, budget_rows: Optional[int] = None,
                 poll_s: float = 0.02, name: str = "compaction-driver",
                 obs=None):
        # name -> index; insertion-ordered, which the round-robin
        # cursor walks.  "" is the default (single-tenant) slot.
        self._indexes: "Dict[str, object]" = {}
        if index is not None:
            self._indexes[""] = index
        self._rr = 0                # round-robin cursor over attachments
        self._fairness: Dict[str, int] = {}  # name -> worker ops run
        self.budget_rows = budget_rows
        self.poll_s = float(poll_s)
        self.name = name
        # share the index's event log by default so driver lifecycle
        # interleaves with freeze/swap events in one stream
        if obs is None:
            obs = getattr(index, "obs", None)
        if obs is None:
            from repro_torch.obs import Observability
            obs = Observability.disabled()
        self.obs = obs
        # one lock excludes worker staging from control-thread swaps;
        # staging never blocks serving for longer than one budgeted
        # gather because the worker re-acquires per stage_step call
        self._mu = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stage_calls = 0       # worker gathers that ran
        self._prepares = 0          # worker speculative segment builds
        self._drains = 0            # control-thread drain() calls
        self._applied = 0           # merges swapped in via drain/flush
        self._flushes = 0
        self._cuts = 0              # consistent-cut snapshot captures
        self._errors: List[str] = []

    # ----------------------------------------------------------- index pool
    @property
    def index(self):
        """The default (single-tenant) index, else the first attached —
        the pre-collections single-index view.  None when empty."""
        if "" in self._indexes:
            return self._indexes[""]
        return next(iter(self._indexes.values()), None)

    def indexes(self) -> Dict[str, object]:
        """Snapshot of the attached pool (name -> index)."""
        with self._mu:
            return dict(self._indexes)

    def attach(self, name: str, index) -> None:
        """CONTROL-THREAD ONLY: add (or replace) a collection's index
        in the pool.  The lock excludes the worker, so the new index is
        visible to its next round-robin turn."""
        with self._mu:
            self._indexes[str(name)] = index
        self.obs.events.emit("driver_attach", name=self.name,
                             collection=str(name))
        self._wake.set()

    def detach(self, name: str):
        """CONTROL-THREAD ONLY: remove a collection's index from the
        pool (idempotent).  Under the lock the worker is never
        mid-stage on it; any staged-but-unapplied work is simply
        abandoned with the index (staging is volatile by contract).
        Returns the detached index, or None."""
        with self._mu:
            idx = self._indexes.pop(str(name), None)
        if idx is not None:
            self.obs.events.emit("driver_detach", name=self.name,
                                 collection=str(name))
        return idx

    # ------------------------------------------------------------ lifecycle
    @property
    def running(self) -> bool:
        """True while the worker thread is alive."""
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "CompactionDriver":
        """Start (or restart) the daemon worker; returns self."""
        if self.running:
            return self
        self._stop.clear()
        self._wake.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=self.name)
        self._thread.start()
        self.obs.events.emit("driver_start", name=self.name,
                             budget_rows=self.budget_rows)
        return self

    def stop(self, flush: bool = False) -> None:
        """CONTROL-THREAD ONLY: join the worker; optionally finish all
        pending merge work inline afterwards (``flush=True``) so no
        staging is left orphaned.  Idempotent; ``start()`` restarts."""
        was_running = self.running
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=60.0)
            if self._thread.is_alive():       # pragma: no cover
                self._errors.append("stop: worker join timed out")
            self._thread = None
        if was_running:
            self.obs.events.emit("driver_stop", name=self.name, flush=flush)
        if flush:
            self.flush()

    def notify(self) -> None:
        """Hint the worker that new merge work may exist (cheap; any
        thread).  Without it the worker still finds work within
        ``poll_s``."""
        self._wake.set()

    # ------------------------------------------------- control-thread ops
    def drain(self) -> int:
        """CONTROL-THREAD ONLY: apply any fully-staged merge swaps.

        The serving loop's between-batches hook (replaces the budgeted
        ``compact_step`` tick): when nothing is staged-ready this is one
        flag check under the lock — the gathers themselves live on the
        worker.  Applies cascaded-ready heads in a loop and returns the
        number of merges swapped in.
        """
        self._drains += 1
        applied = 0
        with self._mu:
            for idx in self._indexes.values():
                while idx.apply_staged():
                    applied += 1
        if applied:
            self._applied += applied
            self._wake.set()          # the worker can stage the next merge
        return applied

    def flush(self) -> int:
        """CONTROL-THREAD ONLY: run every pending merge to completion
        inline (stage remainder + swap), returning merges applied.

        The checkpoint barrier: after a flush there is no staged or
        queued merge, so a snapshot can never capture a half-staged
        state and restores re-derive a clean schedule.  The worker (if
        running) is simply excluded by the lock for the duration.
        """
        self._flushes += 1
        applied = 0
        with self._mu:
            for idx in self._indexes.values():
                while idx.has_compaction_work:
                    if idx.apply_staged():
                        applied += 1
                    else:
                        idx.stage_step(1 << 30)   # stage the remainder
        if applied:
            self._applied += applied
        self.obs.events.emit("flush_barrier", name=self.name,
                             applied=applied)
        return applied

    def consistent_cut(self, capture):
        """CONTROL-THREAD ONLY: run ``capture()`` under the driver lock
        and return its result — a consistent-cut snapshot barrier.

        Unlike ``flush`` this does NOT drain queued merges: the lock
        alone excludes the worker, so the callback sees the index
        between bounded staging gathers.  That is a valid checkpoint
        state because staged merge progress is volatile by contract
        (its inputs are still complete segments on disk; a restore
        re-derives the schedule and restages).  Cost is therefore
        O(capture) — for an incremental snapshot, O(delta + manifest) —
        instead of O(pending compaction), regardless of how much merge
        work is queued.
        """
        self._cuts += 1
        with self._mu:
            out = capture()
        self.obs.events.emit("snapshot_cut", name=self.name)
        return out

    # ------------------------------------------------------------- worker
    def _service_one(self, name: str, idx) -> bool:
        """One bounded worker op on one index (under the lock): a
        pre-build when its head is staged-ready, else a staging
        gather.  Returns True when work ran."""
        if idx.staged_ready:
            # pre-build the merged segment so the control thread's
            # swap is re-check + rewire only.  Once prepared (or on
            # the sharded index, which never pre-builds), the head
            # just waits on a drain — re-polling would spin on the
            # lock.
            if idx.prepare_staged():
                self._prepares += 1
                self._fairness[name] = self._fairness.get(name, 0) + 1
                return True
            return False
        status = idx.stage_step(self.budget_rows)
        if status == "ready":
            self.obs.events.emit("stage_ready", collection=name,
                                 staged_rows=int(idx.staged_rows))
        if status != "idle":
            self._stage_calls += 1
            self._fairness[name] = self._fairness.get(name, 0) + 1
            return True
        return False

    def _run(self) -> None:
        while not self._stop.is_set():
            did_work = False
            try:
                with self._mu:
                    # round-robin: start one past the last serviced
                    # collection, take ONE bounded op from the first
                    # that has work — a churny tenant advances one op
                    # per turn, not until done.
                    names = list(self._indexes)
                    n = len(names)
                    for k in range(n):
                        i = (self._rr + 1 + k) % n
                        if self._service_one(names[i], self._indexes[names[i]]):
                            self._rr = i
                            did_work = True
                            break
            except Exception as e:    # control reset state mid-stage
                # (compact()/restore without stop(): defensive — abandon
                # the gather, the re-derived schedule restages)
                if len(self._errors) < 64:      # bounded: a wedged
                    self._errors.append(repr(e))  # worker must not grow
                did_work = False
            if did_work:
                continue              # more to do right away
            self._wake.wait(self.poll_s)
            self._wake.clear()

    # ------------------------------------------------------ observability
    def stats(self) -> Dict[str, object]:
        """Driver-state snapshot (host ints/bools; any thread).

        ``pending_gathers`` queued merge tasks, ``staged_rows`` rows in
        staging buffers, ``staged_ready`` head-awaiting-swap,
        ``worker_alive``, plus cumulative ``stage_calls`` / ``prepares``
        (worker gathers and pre-builds), ``drains`` / ``applied`` /
        ``flushes`` / ``cuts`` (control-thread side; ``cuts`` counts
        consistent-cut snapshot captures), and ``worker_errors``.
        ``work_seconds`` is the index's per-phase compaction-work
        accumulator — the same dict ``index_stats()`` reports, never a
        second measurement.  With multiple attached collections the
        index-derived fields aggregate over the pool
        (``pending_gathers``/``staged_rows`` sum; ``staged_ready`` =
        any; ``work_seconds`` sums per phase), ``collections`` counts
        attachments, and ``fairness`` maps each collection to the
        worker ops (gathers + pre-builds) it has received — the
        round-robin audit trail.
        """
        with self._mu:
            indexes = dict(self._indexes)
        pending = sum(int(i.pending_merges) for i in indexes.values())
        staged = sum(int(i.staged_rows) for i in indexes.values())
        ready = any(bool(i.staged_ready) for i in indexes.values())
        work: Dict[str, float] = {}
        for i in indexes.values():
            for phase, secs in dict(
                    getattr(i, "compaction_work_seconds", None) or {}).items():
                work[phase] = work.get(phase, 0.0) + secs
        return {
            "worker_alive": self.running,
            "pending_gathers": pending,
            "staged_rows": staged,
            "staged_ready": ready,
            "budget_rows": self.budget_rows,
            "stage_calls": self._stage_calls,
            "prepares": self._prepares,
            "drains": self._drains,
            "applied": self._applied,
            "flushes": self._flushes,
            "cuts": self._cuts,
            "worker_errors": len(self._errors),
            "collections": len(indexes),
            "fairness": dict(self._fairness),
            "work_seconds": work,
        }

    def __repr__(self) -> str:
        pending = sum(int(i.pending_merges)
                      for i in self._indexes.values())
        return (f"CompactionDriver({self.name!r}, "
                f"alive={self.running}, "
                f"collections={len(self._indexes)}, "
                f"pending={pending})")
