"""repro_torch.obs — the observability substrate (docs/observability.md).

Three surfaces, bundled by ``Observability``:

  * ``MetricsRegistry`` — thread-safe counters / gauges / fixed-bucket
    histograms with a near-zero-cost disabled mode (``metrics``).
  * ``QueryTracer``     — per-query route spans: estimated vs actual
    candSize, chosen strategy, probes, and the derived misroute rate —
    the paper's Eq. (1)/(2) cost model as a live calibration signal
    (``trace``).
  * ``EventLog``        — bounded ring buffer of compaction/driver
    lifecycle events: freeze, merge_scheduled, swap, rebalance,
    flush_barrier, ... (``events``).

Export helpers: ``to_prometheus`` text exposition (``export``) and the
documented stats-key schemas (``schema``).

Ownership: ``RetrievalService`` creates one enabled bundle and hands
it to its index + driver; indexes built directly default to a fresh
*disabled* bundle, so nothing pays for observability unless asked.
The query fast path additionally short-circuits on ``tracer.enabled``
— toggling that flag flips tracing at runtime without a rebuild.
"""
from __future__ import annotations

import dataclasses

from repro_torch.obs.events import EventLog, NULL_EVENTS
from repro_torch.obs.export import to_prometheus
from repro_torch.obs.metrics import (DEFAULT_TIME_BUCKETS, Counter, Gauge,
                               Histogram, MetricsRegistry, NULL_REGISTRY,
                               WorkPhases, time_block)
from repro_torch.obs.trace import SPAN_FIELDS, QueryTracer

__all__ = ["Observability", "MetricsRegistry", "NULL_REGISTRY", "Counter",
           "Gauge", "Histogram", "WorkPhases", "time_block",
           "DEFAULT_TIME_BUCKETS", "QueryTracer", "SPAN_FIELDS",
           "EventLog", "NULL_EVENTS", "to_prometheus"]


@dataclasses.dataclass
class Observability:
    """One bundle of the three surfaces, shared index ↔ driver ↔ service."""

    registry: MetricsRegistry
    tracer: QueryTracer
    events: EventLog
    enabled: bool = True

    @classmethod
    def create(cls, enabled: bool = True, *, trace_capacity: int = 256,
               events_capacity: int = 512,
               per_segment_timing: bool = False,
               trace_sample_every: int = 16) -> "Observability":
        """Build a bundle; ``enabled=False`` builds the no-op variant
        (null registry instruments, tracer/events short-circuit).
        ``trace_sample_every`` — trace every Nth query batch (1 traces
        all; see QueryTracer's docstring for the cost model)."""
        registry = MetricsRegistry(enabled=enabled)
        return cls(
            registry=registry,
            tracer=QueryTracer(registry, capacity=trace_capacity,
                               per_segment_timing=per_segment_timing,
                               enabled=enabled,
                               sample_every=trace_sample_every),
            events=EventLog(capacity=events_capacity, enabled=enabled),
            enabled=enabled)

    @classmethod
    def disabled(cls) -> "Observability":
        """A fresh no-op bundle (the default for bare indexes).

        Fresh — not a shared singleton — so enabling one index's
        tracer later (``obs.tracer.enabled = True``) can never
        silently enable another's.
        """
        return cls.create(enabled=False)
