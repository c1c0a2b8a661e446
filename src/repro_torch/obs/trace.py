"""Per-query trace spans through the route decision + misroute rate.

The paper's Algorithm 2 picks LSH-probing or a linear scan per query
from an *estimated* candSize (the per-bucket HyperLogLogs).  This
module turns that choice into a live calibration signal: for every
traced query the engine records what the estimator said (``cand_est``,
``lsh_cost_est``) and what actually happened (``cand_actual`` — the
distinct candidates the LSH route's gather produces, cap-truncated,
exact in the delta), then re-prices Eq. (1) with the actual candSize:

  lsh_cost_actual = alpha * collisions + beta * cand_actual

A query is a **misroute** when the chosen strategy did more work than
the alternative would have cost under actual terms:

  * routed LSH     and  lsh_cost_actual > linear_cost  (should've scanned)
  * routed linear  and  lsh_cost_actual < linear_cost  (should've probed)

with a tiny relative margin so exact cost ties never flag.
``linear_cost`` needs no "actual" counterpart — Eq. (2) is
deterministic in ``n_scan``.  Force-overridden queries
(``force="lsh"|"linear"``) get spans but are excluded from the
misroute rate: the router didn't choose, so the rate would not be
measuring the estimator.  The misroute rate is therefore exactly the
fraction of routed queries whose HLL estimate crossed the Eq. (1)/(2)
boundary in the wrong direction — nonzero on any mixed-density corpus
with borderline queries, and the first thing to watch when tuning
``beta_over_alpha`` or the HLL register count ``m``.

Span fields (``SPAN_FIELDS``; docs/observability.md has the schema):
``strategy``, ``forced``, ``collisions``, ``cand_est``,
``cand_actual``, ``lsh_cost_est``, ``lsh_cost_actual``,
``linear_cost``, ``probes``, ``misroute``.

Granularity: spans are per query; wall-time *phase* timings
(``estimate`` / ``search_lsh`` / ``search_linear`` / ``count_actual``)
are per batch (the engine executes routed groups batched, so per-query
wall time does not exist).  Time per segment or per kernel comes from a
``torch.profiler`` trace of the engine's profiler spans
(``repro_torch.obs.spans``), without device syncs.  Per-level
merge/freeze timings live in the event log, not here.

Cost: a *traced* batch is not free — the ``count_candidates`` pass
that prices the actual candidate set is real device work (roughly the
gather+dedupe half of an LSH search), and the phase timings insert
device syncs that cost pipelining.  The tracer therefore **samples**:
with ``sample_every=N`` only every Nth query batch takes the traced
path; the other N-1 run the byte-identical fast path (results never
differ — tracing is observation only).  The default ``N=16`` keeps the
steady-state overhead of an *enabled* tracer under the 5% budget
(benchmarks/obs_bench.py measures both the sampled and the
every-batch figure); ``sample_every=1`` traces everything, for debug
sessions and for the benchmark's misroute measurement.  Calibration
aggregates (misroute rate, rel-error) are computed over traced batches
only — an unbiased sample, since sampling is by arrival order, not by
content.

Thread safety: ``record_batch`` takes the tracer lock once per batch;
registry instruments carry their own locks.  The engine's untraced
path never calls in (it short-circuits on ``enabled``).
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from repro_torch.obs.metrics import MetricsRegistry

__all__ = ["QueryTracer", "SPAN_FIELDS"]

SPAN_FIELDS = ("strategy", "forced", "collisions", "cand_est",
               "cand_actual", "lsh_cost_est", "lsh_cost_actual",
               "linear_cost", "probes", "misroute")

# relative slack: an actual cost within this of the alternative is a
# tie, not a misroute (exact equality happens on integer-valued costs)
_TIE_MARGIN = 1e-6


class QueryTracer:
    """Ring buffer of per-query route spans + calibration aggregates."""

    def __init__(self, registry: MetricsRegistry, capacity: int = 256,
                 enabled: bool = True, sample_every: int = 16):
        self.enabled = bool(enabled)
        self.capacity = max(int(capacity), 1)
        self.sample_every = max(int(sample_every), 1)
        self._lock = threading.Lock()
        self._calls = 0            # query batches seen while enabled
        self._sampled = 0          # of those, batches actually traced
        self._spans: deque = deque(maxlen=self.capacity)
        self._batches: deque = deque(maxlen=64)   # batch-level phase info
        # cumulative aggregates (never ring-evicted)
        self._queries = 0          # routed (non-forced) queries
        self._misroutes = 0
        self._forced = 0
        self._by_route = {"lsh": {"queries": 0, "misroutes": 0,
                                  "rel_err_sum": 0.0},
                          "linear": {"queries": 0, "misroutes": 0,
                                     "rel_err_sum": 0.0}}
        # registry series (null instruments when the registry is off)
        self._m_queries = {
            s: registry.counter("repro_queries_total",
                                help="queries served, by chosen route",
                                labels={"route": s})
            for s in ("lsh", "linear")}
        self._m_misroutes = {
            s: registry.counter(
                "repro_misroutes_total",
                help="queries whose chosen route cost more than the "
                     "alternative under actual candSize",
                labels={"route": s})
            for s in ("lsh", "linear")}
        self._m_rel_err = {
            s: registry.histogram(
                "repro_cand_rel_error",
                buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 10.0),
                help="|cand_est - cand_actual| / max(cand_actual, 1)",
                labels={"route": s})
            for s in ("lsh", "linear")}
        # phase histograms are labeled (phase, impl) so the exposition
        # shows which kernel backend served each route (the CUDA
        # kernels on the card, the plain versions elsewhere); series are created
        # lazily per observed backend (get-or-create is cheap)
        self._registry = registry
        self._m_phase: Dict[tuple, object] = {}
        self._last_impl: Optional[str] = None
        # multi-tenant context: extra fields stamped on every span
        # recorded while set (e.g. {"collection": name}); the serving
        # layer sets it around a collection's query — control-thread
        # only, like the query path itself
        self._context: Dict[str, object] = {}

    def set_context(self, **fields) -> None:
        """Stamp ``fields`` on subsequently recorded spans (pass
        nothing to clear).  ``RetrievalService`` brackets each
        collection's index query with
        ``set_context(collection=name)`` so one shared tracer's spans
        stay attributable per tenant."""
        self._context = {k: v for k, v in fields.items() if v is not None}

    def _phase_hist(self, phase: str, impl: str):
        key = (phase, impl)
        h = self._m_phase.get(key)
        if h is None:
            h = self._registry.histogram(
                "repro_query_phase_seconds",
                help="wall seconds per traced query batch, by phase and "
                     "kernel impl",
                labels={"phase": phase, "impl": impl})
            self._m_phase[key] = h
        return h

    # ------------------------------------------------------------ sample
    def sample(self) -> bool:
        """One call per query batch: True → the engine takes the traced
        path for this batch.  Every ``sample_every``-th call samples
        (the first always does, so short-lived tracers still trace)."""
        with self._lock:
            hit = (self._calls % self.sample_every) == 0
            self._calls += 1
            if hit:
                self._sampled += 1
        return hit

    # ------------------------------------------------------------ record
    def record_batch(self, *, use_lsh: np.ndarray, collisions: np.ndarray,
                     cand_est: np.ndarray, cand_actual: np.ndarray,
                     lsh_cost_est: np.ndarray, lsh_cost_actual: np.ndarray,
                     linear_cost: float, probes: int,
                     forced: Optional[str],
                     phase_seconds: Dict[str, float],
                     segment_seconds: Optional[Dict[str, list]] = None,
                     kernel_impl: Optional[str] = None
                     ) -> None:
        """Fold one engine batch into spans + aggregates.

        All per-query arrays are (Q,) host numpy; ``linear_cost`` is
        the batch's scalar Eq. (2) cost; ``forced`` is the engine's
        strategy override (those queries get spans but do not count
        toward the misroute rate); ``kernel_impl`` is the resolved
        kernel backend (``ops.resolve_impl``) that served the search
        phases — it labels the phase histograms.
        """
        use = np.asarray(use_lsh, bool)
        nq = int(use.shape[0])
        lin = float(linear_cost)
        margin = _TIE_MARGIN * max(abs(lin), 1.0)
        lsh_act = np.asarray(lsh_cost_actual, np.float64)
        # chosen-lsh misroute: did more work than the known linear cost;
        # chosen-linear misroute: probing would have been cheaper
        mis = np.where(use, lsh_act > lin + margin, lsh_act < lin - margin)
        rel_err = (np.abs(np.asarray(cand_est, np.float64)
                          - np.asarray(cand_actual, np.float64))
                   / np.maximum(np.asarray(cand_actual, np.float64), 1.0))

        spans = []
        ctx = dict(self._context)
        for i in range(nq):
            strat = "lsh" if use[i] else "linear"
            spans.append({
                **ctx,
                "strategy": strat,
                "forced": forced is not None,
                "collisions": int(collisions[i]),
                "cand_est": float(cand_est[i]),
                "cand_actual": int(cand_actual[i]),
                "lsh_cost_est": float(lsh_cost_est[i]),
                "lsh_cost_actual": float(lsh_act[i]),
                "linear_cost": lin,
                "probes": int(probes),
                "misroute": bool(mis[i]),
            })

        with self._lock:
            self._spans.extend(spans)
            self._last_impl = kernel_impl
            self._batches.append({
                "n_queries": nq, "forced": forced,
                "phase_seconds": dict(phase_seconds),
                "segment_seconds": segment_seconds,
                "kernel_impl": kernel_impl,
            })
            if forced is None:
                self._queries += nq
                self._misroutes += int(mis.sum())
                for s in ("lsh", "linear"):
                    sel = use if s == "lsh" else ~use
                    agg = self._by_route[s]
                    agg["queries"] += int(sel.sum())
                    agg["misroutes"] += int(mis[sel].sum())
                    agg["rel_err_sum"] += float(rel_err[sel].sum())
            else:
                self._forced += nq

        for s in ("lsh", "linear"):
            sel = use if s == "lsh" else ~use
            k = int(sel.sum())
            if k and forced is None:
                self._m_queries[s].inc(k)
                self._m_misroutes[s].inc(int(mis[sel].sum()))
                for e in rel_err[sel]:
                    self._m_rel_err[s].observe(float(e))
        impl_label = kernel_impl or "auto"
        for p, sec in phase_seconds.items():
            self._phase_hist(p, impl_label).observe(float(sec))

    # ----------------------------------------------------------- readout
    @property
    def misroute_rate(self) -> float:
        with self._lock:
            return self._misroutes / max(self._queries, 1)

    def spans(self, limit: Optional[int] = None,
              strategy: Optional[str] = None) -> List[Dict[str, object]]:
        """Newest-last copies of retained spans."""
        with self._lock:
            out = list(self._spans)
        if strategy is not None:
            out = [s for s in out if s["strategy"] == strategy]
        if limit is not None:
            out = out[-int(limit):]
        return [dict(s) for s in out]

    def summary(self) -> Dict[str, object]:
        """Cumulative calibration aggregates (JSON-serializable)."""
        with self._lock:
            by_route = {}
            for s, agg in self._by_route.items():
                q = agg["queries"]
                by_route[s] = {
                    "queries": q,
                    "misroutes": agg["misroutes"],
                    "misroute_rate": agg["misroutes"] / max(q, 1),
                    "cand_rel_err_mean": agg["rel_err_sum"] / max(q, 1),
                }
            last = self._batches[-1] if self._batches else None
            return {
                "sample_every": self.sample_every,
                "batches_seen": self._calls,
                "batches_traced": self._sampled,
                "queries": self._queries,
                "misroutes": self._misroutes,
                "misroute_rate": self._misroutes / max(self._queries, 1),
                "forced_queries": self._forced,
                "frac_lsh": (by_route["lsh"]["queries"]
                             / max(self._queries, 1)),
                "kernel_impl": self._last_impl,
                "by_route": by_route,
                "spans_retained": len(self._spans),
                "last_batch": dict(last) if last else None,
            }
