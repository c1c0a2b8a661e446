"""Request scheduler: shape-bucketed batching with hybrid routing.

The scheduler accumulates requests and forms batches padded to
power-of-two sizes (a small set of batch shapes), and — for retrieval
requests — the paper's cost estimator runs FIRST so that a micro-batch
executes one strategy per group (``route_and_group``).  The groups
keep the reference's power-of-two padding (``repro.serve.scheduler``);
the port's query path itself runs its groups unpadded
(``core.engine.partition_indices``), so the padding lives here only.

Cross-request coalescing (docs/serving.md): with ``max_wait_s > 0``
``next_batch`` holds small queues back until either the queue can fill
a whole ``max_batch`` or the *oldest* request has waited out the
deadline, so many single-query submits merge into one dense pow2
bucket instead of draining as singleton batches.  ``max_wait_s = 0``
(default) drains greedily — exactly the pre-coalescing behavior.
Admission control: with ``max_queue`` set, submits beyond the bound
are rejected (``submit`` returns None, counted in
``repro_scheduler_rejects_total``) instead of growing the queue — and
the latency SLO — without bound.

Multi-tenant serving (docs/serving.md "Collections"): every request
carries a collection id (the default corpus is the reserved empty name
``""``).  ``set_quota`` attaches a per-tenant token bucket
(``rate`` tokens/s refill, ``burst`` capacity) so a flooding tenant is
rejected at ITS OWN bucket — before the global queue bound — and a
quiet tenant keeps being admitted; rejects are counted per collection
(``repro_scheduler_rejects_total{collection=...}``) on top of the
unlabeled aggregate.  ``next_batch`` drains *weighted-fair* across the
tenants present in the queue: batch slots are allocated proportionally
to quota weights (largest-remainder, leftover filled in global FIFO
age order), so a backlogged tenant cannot starve another's queue-wait
even when both are inside their buckets.  Single-tenant queues drain
pure FIFO — bit-identical to the pre-collections behavior.

The scheduler is also the natural interleaving point for *off-query-
path* index maintenance: register a ``background_tick`` (typically a
``CompactionDriver.drain``) and it runs once per
``next_batch`` call — empty and not-yet-ready drains included, so a
quiet serving loop still advances merges.  What a tick costs depends
on where the merges are staged (docs/compaction.md):

  * budgeted — the tick runs one bounded LSM merge step (a gather of
    ``compact_step_rows`` rows) on this thread, between batches
    instead of inside one;
  * async    — the gathers live on the ``CompactionDriver``'s worker
    thread and the tick degenerates to the driver's ``drain()``: a
    flag check, plus the atomic level swap when one is staged-ready.
    The serving thread never pays for staging at all.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.engine import _pad_size

from repro_torch.obs.metrics import DEFAULT_TIME_BUCKETS, NULL_REGISTRY


@dataclasses.dataclass
class Request:
    uid: int
    payload: Any
    t_submit: float = 0.0       # scheduler clock at submit
    wait_s: float = 0.0         # queue wait, stamped when the batch forms
    collection: str = ""        # tenant id; "" = the default corpus


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """Per-collection admission quota + drain weight.

    ``rate`` tokens/s refill a bucket of ``burst`` capacity; each
    admitted submit spends one token, an empty bucket rejects.  The
    defaults (inf/inf) never reject — a tenant with no quota set is
    limited only by the global ``max_queue``.  ``weight`` scales the
    tenant's share of batch slots under weighted drain.
    """
    rate: float = math.inf
    burst: float = math.inf
    weight: float = 1.0


class _TenantState:
    """One collection's token bucket + serving counters."""

    __slots__ = ("quota", "tokens", "t_refill", "submits", "rejects",
                 "batched", "wait_max")

    def __init__(self, quota: TenantQuota, now: float):
        self.quota = quota
        self.tokens = quota.burst
        self.t_refill = now
        self.submits = 0
        self.rejects = 0
        self.batched = 0
        self.wait_max = 0.0

    def try_take(self, now: float) -> bool:
        """Refill by elapsed time, then spend one token if available."""
        q = self.quota
        if math.isinf(q.rate) and math.isinf(q.burst):
            return True
        self.tokens = min(q.burst,
                          self.tokens + (now - self.t_refill) * q.rate)
        self.t_refill = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


class ShapeBucketScheduler:
    def __init__(self, max_batch: int = 64, min_bucket: int = 8,
                 background_tick: Optional[Callable[[], Any]] = None,
                 registry=None, max_wait_s: float = 0.0,
                 max_queue: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic):
        """``registry`` — optional ``repro_torch.obs.MetricsRegistry``; the
        default null registry makes every instrument a no-op.

        ``max_wait_s`` — coalescing deadline: ``next_batch`` returns an
        empty batch (without counting a phantom batch) until the queue
        holds ``max_batch`` requests or the oldest has waited this
        long.  0 (default) drains greedily.
        ``max_queue`` — admission bound: ``submit`` beyond it returns
        None and counts a reject.  None (default) = unbounded.
        ``clock`` — monotonic time source (injectable for tests).
        """
        self.max_batch = max_batch
        self.min_bucket = min_bucket
        self.background_tick = background_tick
        self.max_wait_s = float(max_wait_s)
        self.max_queue = max_queue
        self.clock = clock
        self.queue: List[Request] = []
        self._tenants: Dict[str, _TenantState] = {}
        self._uid = 0
        self._ticks = 0
        self._submits = 0
        self._rejects = 0
        self._batches = 0
        self._requests_batched = 0
        self._wait_sum = 0.0
        self._wait_max = 0.0
        reg = registry if registry is not None else NULL_REGISTRY
        self._m_submits = reg.counter(
            "repro_scheduler_submits_total", help="Requests submitted")
        self._m_rejects = reg.counter(
            "repro_scheduler_rejects_total",
            help="Requests rejected by admission control (queue full)")
        self._m_batches = reg.counter(
            "repro_scheduler_batches_total", help="Batches formed")
        self._m_batch_size = reg.histogram(
            "repro_scheduler_batch_size",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128),
            help="Requests per formed batch (pre-padding)")
        self._m_queue_wait = reg.histogram(
            "repro_scheduler_queue_wait_seconds",
            buckets=DEFAULT_TIME_BUCKETS,
            help="Per-request queue wait (submit -> batch formed)")
        self._m_ticks = reg.counter(
            "repro_scheduler_ticks_total", help="Background ticks run")
        self._registry = reg

    # ------------------------------------------------------------ tenants
    def _tenant(self, collection: str) -> _TenantState:
        st = self._tenants.get(collection)
        if st is None:
            st = _TenantState(TenantQuota(), self.clock())
            self._tenants[collection] = st
        return st

    def set_quota(self, collection: str, *, rate: float = math.inf,
                  burst: Optional[float] = None,
                  weight: float = 1.0) -> None:
        """Attach (or replace) a tenant's token-bucket quota.

        ``rate`` tokens/s, ``burst`` bucket capacity (default: ``rate``,
        so one second of headroom), ``weight`` the drain share.  The
        bucket starts full; replacing a quota refills it.
        """
        if burst is None:
            burst = rate
        q = TenantQuota(rate=float(rate), burst=float(burst),
                        weight=float(weight))
        self._tenants[str(collection)] = _TenantState(q, self.clock())

    def drop_collection(self, collection: str) -> int:
        """Remove a tenant: its queued requests are discarded (they
        will never be served — callers drop the uids) and its quota and
        counters are forgotten.  Returns the number of requests
        dropped from the queue."""
        collection = str(collection)
        n0 = len(self.queue)
        self.queue = [r for r in self.queue if r.collection != collection]
        self._tenants.pop(collection, None)
        return n0 - len(self.queue)

    def _reject(self, collection: str, st: _TenantState,
                reason: str) -> None:
        self._rejects += 1
        st.rejects += 1
        self._m_rejects.inc()
        self._registry.counter(
            "repro_scheduler_rejects_total",
            help="Requests rejected by admission control (queue full)",
            labels={"collection": collection, "reason": reason}).inc()

    def submit(self, payload, collection: str = "") -> Optional[int]:
        """Enqueue a request; returns its uid, or None when admission
        control sheds it — either the tenant's own token bucket is
        empty (``reason="quota"``) or the global queue already holds
        ``max_queue`` requests (``reason="queue_full"``)."""
        collection = str(collection)
        st = self._tenant(collection)
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            self._reject(collection, st, "queue_full")
            return None
        if not st.try_take(self.clock()):
            self._reject(collection, st, "quota")
            return None
        st.submits += 1
        self._uid += 1
        self.queue.append(Request(self._uid, payload,
                                  t_submit=self.clock(),
                                  collection=collection))
        self._submits += 1
        self._m_submits.inc()
        return self._uid

    def _bucket(self, k: int) -> int:
        if k == 0:
            return 0
        return min(self.max_batch,
                   max(self.min_bucket, 1 << (k - 1).bit_length()))

    def _ready(self, now: float) -> bool:
        if not self.queue:
            return False
        if len(self.queue) >= self.max_batch or self.max_wait_s <= 0.0:
            return True
        return (now - self.queue[0].t_submit) >= self.max_wait_s

    def _select(self, k: int) -> List[Request]:
        """Pop up to ``k`` requests, weighted-fair across tenants.

        When everything fits (or one tenant owns the queue) this is the
        plain FIFO pop.  Otherwise batch slots are allocated to tenants
        in proportion to their quota weights (floor), the remainder
        filled one slot at a time by global FIFO age — so a backlogged
        tenant gets its share, never the whole batch.  The popped batch
        preserves submit order (uid order) regardless of allocation.
        """
        if len(self.queue) <= k:
            take, self.queue = self.queue, []
            return take
        by_col: Dict[str, List[Request]] = {}
        for req in self.queue:
            by_col.setdefault(req.collection, []).append(req)
        if len(by_col) == 1:
            take = self.queue[:k]
            self.queue = self.queue[k:]
            return take
        weights = {c: self._tenant(c).quota.weight for c in by_col}
        total_w = sum(weights.values()) or 1.0
        alloc = {c: min(len(by_col[c]), int(k * weights[c] / total_w))
                 for c in by_col}
        rem = k - sum(alloc.values())
        while rem > 0:
            live = [c for c in by_col if alloc[c] < len(by_col[c])]
            if not live:
                break
            oldest = min(live, key=lambda c: by_col[c][alloc[c]].uid)
            alloc[oldest] += 1
            rem -= 1
        chosen = {req.uid for c, reqs in by_col.items()
                  for req in reqs[:alloc[c]]}
        take = [r for r in self.queue if r.uid in chosen]
        self.queue = [r for r in self.queue if r.uid not in chosen]
        return take

    def next_batch(self, force: bool = False) -> Tuple[List[Request], int]:
        """Pop up to max_batch requests; returns (requests, padded_size).

        Padded size is the pow2 bucket: the runner repeats the last
        payload to fill and drops the padded results.  Under a
        coalescing deadline (``max_wait_s > 0``) a short queue whose
        oldest request is still inside the deadline returns ``([], 0)``
        — pass ``force=True`` to flush it anyway (shutdown, test
        barriers).  Empty and not-ready drains count NO batch and
        record nothing in the batch-size histogram (a phantom
        zero-size batch would drag the occupancy stats); the
        registered ``background_tick`` still runs every call, so
        maintenance work (a bounded LSM ``compact_step``, or in
        async-compaction mode the driver's cheap ``drain()``)
        interleaves between query batches even when traffic pauses.
        """
        now = self.clock()
        if force and self.queue or self._ready(now):
            take = self._select(self.max_batch)
            self._batches += 1
            self._m_batches.inc()
            self._m_batch_size.observe(len(take))
            for req in take:
                req.wait_s = max(now - req.t_submit, 0.0)
                self._m_queue_wait.observe(req.wait_s)
                self._wait_sum += req.wait_s
                self._wait_max = max(self._wait_max, req.wait_s)
                st = self._tenant(req.collection)
                st.batched += 1
                st.wait_max = max(st.wait_max, req.wait_s)
            self._requests_batched += len(take)
        else:
            take = []
        if self.background_tick is not None:
            self._ticks += 1
            self._m_ticks.inc()
            self.background_tick()
        return take, self._bucket(len(take))

    @property
    def ticks(self) -> int:
        return self._ticks

    def stats(self) -> Dict[str, float]:
        """Host-side counters snapshot (schema: SCHEDULER_STATS_KEYS).

        ``tenants`` maps each collection seen (submitted to, or given a
        quota) to its per-tenant view, pinned by
        ``SCHEDULER_TENANT_KEYS``: admitted ``submits``, ``rejects``
        (quota + queue-full), ``batched``, live ``queue_depth``,
        current bucket ``tokens``, the quota (``rate``/``burst``/
        ``weight``), and ``queue_wait_max_s``.
        """
        depth: Dict[str, int] = {}
        for req in self.queue:
            depth[req.collection] = depth.get(req.collection, 0) + 1
        tenants = {}
        for name, st in self._tenants.items():
            tenants[name] = {
                "submits": st.submits,
                "rejects": st.rejects,
                "batched": st.batched,
                "queue_depth": depth.get(name, 0),
                "tokens": st.tokens,
                "rate": st.quota.rate,
                "burst": st.quota.burst,
                "weight": st.quota.weight,
                "queue_wait_max_s": st.wait_max,
            }
        return {
            "queue_depth": len(self.queue),
            "submits": self._submits,
            "rejects": self._rejects,
            "batches": self._batches,
            "requests_batched": self._requests_batched,
            "ticks": self._ticks,
            "queue_wait_sum_s": self._wait_sum,
            "queue_wait_max_s": self._wait_max,
            "max_batch": self.max_batch,
            "max_wait_s": self.max_wait_s,
            "max_queue": self.max_queue,
            "tenants": tenants,
        }


def route_and_group(estimates_use_lsh, min_bucket: int = 8):
    """Split a retrieval batch into per-strategy index groups
    (lsh_idx, linear_idx), each padded to a power-of-two length (at least
    ``min_bucket``) by repeating its last index; an empty group stays
    empty.  The reference's ``partition_indices(minimum=)``: results
    for padded slots are discarded by the caller.  ``estimates_use_lsh``
    is a (Q,) bool array or tensor."""
    if isinstance(estimates_use_lsh, torch.Tensor):
        estimates_use_lsh = estimates_use_lsh.cpu().numpy()
    use_lsh = np.asarray(estimates_use_lsh, bool)

    def pad(idx):
        tgt = _pad_size(len(idx), min_bucket)
        if tgt == 0:
            return idx.astype(np.int32)
        out = np.full(tgt, idx[-1], np.int32)
        out[:len(idx)] = idx
        return out

    return pad(np.nonzero(use_lsh)[0]), pad(np.nonzero(~use_lsh)[0])
