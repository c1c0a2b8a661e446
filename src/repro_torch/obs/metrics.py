"""Thread-safe metrics registry: counters, gauges, fixed-bucket histograms.

Design constraints (docs/observability.md):

  * Thread safety — instruments are written from the serving thread
    AND the ``CompactionDriver`` worker.  Every mutable instrument
    carries its own small lock; reads (``snapshot``/``collect``) take
    the same locks per instrument, so a snapshot is per-series
    coherent without a global pause.
  * Near-zero-cost disabled mode — a registry built with
    ``enabled=False`` hands out shared *null* instruments whose
    mutators are empty methods.  Callers keep unconditional
    ``counter.inc()`` call sites; the disabled cost is one no-op
    method call, and the hot query path (``core.engine``) additionally
    short-circuits on ``tracer.enabled`` so it pays nothing at all.
  * Fixed buckets — histograms take their upper bounds at creation
    (Prometheus-style cumulative ``le`` buckets with an implicit
    ``+Inf``); no dynamic resizing, so ``observe`` is O(#buckets).

``WorkPhases`` is the timer-accumulator the streaming stack uses for
merge work: one named phase per half of the compaction pipeline
(stage / build / apply / full), accumulated via ``time_block`` so each
interval is measured exactly once and reported identically wherever it
surfaces (``index_stats()["work_seconds"]`` and the driver ``stats()``
sub-dict read the same accumulator).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "NULL_REGISTRY", "WorkPhases", "time_block",
           "DEFAULT_TIME_BUCKETS"]

# decade ladder for wall-time histograms (seconds)
DEFAULT_TIME_BUCKETS: Tuple[float, ...] = (
    1e-5, 1e-4, 1e-3, 1e-2, 0.1, 1.0, 10.0)

Labels = Tuple[Tuple[str, str], ...]


def _series_key(name: str, labels: Labels) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return f"{name}{{{inner}}}"


class Counter:
    """Monotone float counter (inc-only)."""

    kind = "counter"
    __slots__ = ("name", "labels", "help", "_lock", "_value")

    def __init__(self, name: str, labels: Labels = (), help: str = ""):
        self.name, self.labels, self.help = name, labels, help
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError("counters only increase")
        with self._lock:
            self._value += v

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Set/add float gauge."""

    kind = "gauge"
    __slots__ = ("name", "labels", "help", "_lock", "_value")

    def __init__(self, name: str, labels: Labels = (), help: str = ""):
        self.name, self.labels, self.help = name, labels, help
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, v: float) -> None:
        with self._lock:
            self._value += v

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket cumulative histogram (Prometheus ``le`` semantics).

    ``buckets`` are sorted upper bounds; an implicit ``+Inf`` bucket
    catches the rest.  ``counts[i]`` is *non*-cumulative per bucket
    internally; ``cumulative()`` folds them for exposition.
    """

    kind = "histogram"
    __slots__ = ("name", "labels", "help", "buckets", "_lock", "_counts",
                 "_sum", "_count")

    def __init__(self, name: str, buckets: Sequence[float],
                 labels: Labels = (), help: str = ""):
        self.name, self.labels, self.help = name, labels, help
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)   # +Inf tail
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        i = 0
        for b in self.buckets:          # few fixed buckets: linear scan
            if v <= b:
                break
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def time(self) -> "time_block":
        """Context manager observing the block's wall time."""
        return time_block(histogram=self)

    def cumulative(self) -> List[Tuple[float, int]]:
        """[(le, cumulative count)] including the +Inf bucket."""
        with self._lock:
            counts = list(self._counts)
        out, running = [], 0
        for b, c in zip(self.buckets + (float("inf"),), counts):
            running += c
            out.append((b, running))
        return out

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def count(self) -> int:
        with self._lock:
            return self._count


class _NullCounter:
    kind = "counter"
    name, labels, help, value = "null", (), "", 0.0

    def inc(self, v: float = 1.0) -> None:
        pass


class _NullGauge:
    kind = "gauge"
    name, labels, help, value = "null", (), "", 0.0

    def set(self, v: float) -> None:
        pass

    def add(self, v: float) -> None:
        pass


class _NullHistogram:
    kind = "histogram"
    name, labels, help = "null", (), ""
    buckets: Tuple[float, ...] = (1.0,)
    sum, count = 0.0, 0

    def observe(self, v: float) -> None:
        pass

    def time(self) -> "time_block":
        return time_block()

    def cumulative(self) -> List[Tuple[float, int]]:
        return []


_NULL_COUNTER = _NullCounter()
_NULL_GAUGE = _NullGauge()
_NULL_HISTOGRAM = _NullHistogram()


class MetricsRegistry:
    """Named instrument factory + snapshot/collect surface.

    ``counter``/``gauge``/``histogram`` are get-or-create: the same
    (name, labels) pair always returns the same instrument, so call
    sites can re-resolve by name instead of threading objects around.
    Re-requesting a name as a different kind raises.  Disabled
    registries return the shared null instruments (no allocation, no
    state, no locks).
    """

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._instruments: Dict[Tuple[str, Labels], object] = {}

    @staticmethod
    def _labels(labels: Optional[Dict[str, str]]) -> Labels:
        if not labels:
            return ()
        return tuple(sorted((str(k), str(v)) for k, v in labels.items()))

    def _get(self, name: str, labels: Labels, kind: str, factory):
        with self._lock:
            inst = self._instruments.get((name, labels))
            if inst is None:
                inst = factory()
                self._instruments[(name, labels)] = inst
            elif inst.kind != kind:
                raise TypeError(
                    f"{name!r} already registered as {inst.kind}, "
                    f"requested {kind}")
            return inst

    def counter(self, name: str, help: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        if not self.enabled:
            return _NULL_COUNTER
        lb = self._labels(labels)
        return self._get(name, lb, "counter",
                         lambda: Counter(name, lb, help))

    def gauge(self, name: str, help: str = "",
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        if not self.enabled:
            return _NULL_GAUGE
        lb = self._labels(labels)
        return self._get(name, lb, "gauge", lambda: Gauge(name, lb, help))

    def histogram(self, name: str,
                  buckets: Sequence[float] = DEFAULT_TIME_BUCKETS,
                  help: str = "",
                  labels: Optional[Dict[str, str]] = None) -> Histogram:
        if not self.enabled:
            return _NULL_HISTOGRAM
        lb = self._labels(labels)
        return self._get(name, lb, "histogram",
                         lambda: Histogram(name, buckets, lb, help))

    def collect(self) -> List[object]:
        """Instruments sorted by (name, labels) — the exposition order."""
        with self._lock:
            items = sorted(self._instruments.items())
        return [inst for _, inst in items]

    def snapshot(self) -> Dict[str, object]:
        """JSON-serializable dump of every series."""
        out: Dict[str, object] = {"enabled": self.enabled,
                                  "counters": {}, "gauges": {},
                                  "histograms": {}}
        for inst in self.collect():
            key = _series_key(inst.name, inst.labels)
            if inst.kind == "counter":
                out["counters"][key] = inst.value
            elif inst.kind == "gauge":
                out["gauges"][key] = inst.value
            else:
                out["histograms"][key] = {
                    "buckets": [[le, c] for le, c in inst.cumulative()],
                    "sum": inst.sum, "count": inst.count}
        return out


NULL_REGISTRY = MetricsRegistry(enabled=False)


class WorkPhases:
    """Thread-safe named wall-time accumulators (seconds per phase).

    The one home of compaction work-seconds: ``SegmentStack`` /
    ``ShardedDynamicHybridIndex`` add each measured interval exactly
    once (via ``time_block``), and every reporting surface —
    ``index_stats()``, the driver ``stats()`` sub-dict — reads the
    same accumulator, so staged (worker) and control-thread halves can
    never double-count.
    """

    def __init__(self, *phases: str):
        self._lock = threading.Lock()
        self._seconds: Dict[str, float] = {p: 0.0 for p in phases}

    def add(self, phase: str, seconds: float) -> None:
        with self._lock:
            self._seconds[phase] = self._seconds.get(phase, 0.0) + seconds

    def as_dict(self) -> Dict[str, float]:
        with self._lock:
            out = dict(self._seconds)
        out["total"] = sum(out.values())
        return out

    @property
    def total(self) -> float:
        with self._lock:
            return sum(self._seconds.values())


class time_block:
    """Measure a block's wall time once; fan the interval out.

    ``elapsed`` is set on exit; optional sinks: a ``Histogram``
    (``observe``) and/or a ``WorkPhases`` accumulator (``add(phase)``).
    Exceptions propagate (the interval is still recorded).
    """

    __slots__ = ("histogram", "phases", "phase", "t0", "elapsed")

    def __init__(self, histogram=None, phases: Optional[WorkPhases] = None,
                 phase: Optional[str] = None):
        self.histogram = histogram
        self.phases = phases
        self.phase = phase
        self.t0 = 0.0
        self.elapsed = 0.0

    def __enter__(self) -> "time_block":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.elapsed = time.perf_counter() - self.t0
        if self.histogram is not None:
            self.histogram.observe(self.elapsed)
        if self.phases is not None and self.phase is not None:
            self.phases.add(self.phase, self.elapsed)
