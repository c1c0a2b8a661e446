"""Bounded ring-buffer event log for compaction/driver lifecycle.

Replaces ad-hoc timing plumbing as the *narrative* record of index
maintenance: each entry is one structured lifecycle event —

  kind               emitted by                        payload fields
  ────────────────── ───────────────────────────────── ─────────────────
  freeze             index ``_freeze``                 rows, reason
  merge_scheduled    index ``_schedule_merges``        uids, target_level,
                                                       reason
  swap               index merge absorption            target_level, rows,
                                                       dropped, steps,
                                                       seconds, reason
  rebalance          sharded merge swap (moved > 0)    rows_moved,
                                                       target_level
  full_compact       index ``compact()``               reason, dropped,
                                                       seconds
  stage_ready        driver worker (staging complete)  staged_rows
  flush_barrier      driver ``flush()``                applied
  driver_start /     driver lifecycle                  name, budget_rows /
  driver_stop                                          name, flush
  shutdown           ``RetrievalService.shutdown``     flush

Every event additionally carries ``seq`` (monotone, counts *all*
events ever emitted — so ``seq - len(log)`` is the number evicted by
the ring bound) and ``ts`` (``time.time()`` wall clock).

Thread safety: ``emit`` may be called from the serving thread and the
``CompactionDriver`` worker concurrently; a single lock guards the
deque and the sequence counter.  Disabled logs short-circuit before
taking the lock.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

__all__ = ["EventLog", "NULL_EVENTS"]


class EventLog:
    def __init__(self, capacity: int = 512, enabled: bool = True):
        self.capacity = max(int(capacity), 1)
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._events: List[Dict[str, object]] = []
        self._seq = 0

    def emit(self, kind: str, **fields) -> None:
        """Append one event; O(1), bounded by ``capacity``."""
        if not self.enabled:
            return
        ev: Dict[str, object] = {"seq": 0, "ts": time.time(), "kind": kind}
        ev.update(fields)
        with self._lock:
            ev["seq"] = self._seq
            self._seq += 1
            self._events.append(ev)
            if len(self._events) > self.capacity:
                del self._events[:len(self._events) - self.capacity]

    def events(self, kind: Optional[str] = None,
               limit: Optional[int] = None) -> List[Dict[str, object]]:
        """Newest-last copies of retained events, optionally filtered by
        ``kind`` and truncated to the most recent ``limit``."""
        with self._lock:
            evs = list(self._events)
        if kind is not None:
            evs = [e for e in evs if e["kind"] == kind]
        if limit is not None:
            evs = evs[-int(limit):]
        return [dict(e) for e in evs]

    def counts_by_kind(self) -> Dict[str, int]:
        """kind -> count over *retained* events (ring-bounded)."""
        out: Dict[str, int] = {}
        with self._lock:
            for e in self._events:
                k = str(e["kind"])
                out[k] = out.get(k, 0) + 1
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    @property
    def seq(self) -> int:
        """Total events ever emitted (evicted ones included)."""
        with self._lock:
            return self._seq

    @property
    def dropped(self) -> int:
        """Events evicted by the ring bound."""
        with self._lock:
            return self._seq - len(self._events)


NULL_EVENTS = EventLog(capacity=1, enabled=False)
