"""Reduction of the program's own profiler spans over the traced stretch.

The port opens ``hlsh.*`` ranges on its query path (``repro_torch.obs.
spans``): ``hlsh.query`` around an index call and, as its direct children,
the phases ``hlsh.hash``, ``hlsh.estimate``, ``hlsh.route``,
``hlsh.search.lsh`` and ``hlsh.search.linear``; ``hlsh.delta.counts`` and
``hlsh.delta.search`` nest inside them.  Over the window of
``trace.reduce`` (the first ``bench.query`` range's start to the last
one's end) this puts

  * each idle instant of the device down to the innermost phase open on
    the control thread then, or to ``hlsh.query`` (inside a call, outside
    its phases), or to ``outside`` (outside any call); the parts add up to
    the window less the union of device activity, the idle of
    ``device_idle_pct``;
  * each kernel down to the innermost span open when the host launched it
    (``Event.launch``, the profiler's link from a kernel to its launch);
  * the host seconds spent inside each span.

A trace without ``hlsh.*`` ranges (a program that opens none) reduces to
the window alone, and every reading below is ``None``.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

from bench.lib import trace

PREFIX = "hlsh."
QUERY = "hlsh.query"
OUTSIDE = "outside"
# the CUDA runtime's and driver's calls (cudaLaunchKernel, cuLaunchKernel,
# cudaMemcpyAsync ...), which share a correlation id with the device work
LAUNCHES = "cu"


@dataclasses.dataclass
class Event(trace.Event):
    launch: Optional[float] = None   # device: its launching call's start


def collect(prof) -> List[Event]:
    """The trace's events as ``Event``s with each device event's launch
    time.  Device copies of the benchmark's and the program's own ranges
    are left out: they are not device work."""
    from torch.autograd import DeviceType
    evs = list(prof.events())
    launched = {e.id: float(e.time_range.start) for e in evs
                if e.device_type == DeviceType.CPU
                and e.name.startswith(LAUNCHES)}
    out = []
    for e in evs:
        dev = e.device_type != DeviceType.CPU
        if dev and (e.name in trace.SPANS or e.name.startswith(PREFIX)):
            continue
        tr = e.time_range
        out.append(Event(e.name, dev, float(tr.start), float(tr.end),
                         int(getattr(e, "thread", 0) or 0),
                         launched.get(e.id) if dev else None))
    return out


def _innermost(spans: List, starts: List[float], t: float):
    """The latest-starting span (``spans`` sorted by start) open at t."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 256, -1), -1):
        if spans[j].end >= t:
            return spans[j]
    return None


def _phases(spans: List) -> List:
    """The spans whose innermost enclosing ``hlsh.*`` span is a
    ``hlsh.query`` (``spans`` sorted by start, one thread, nested)."""
    out, stack = [], []
    for s in spans:
        while stack and stack[-1].end < s.start:
            stack.pop()
        if stack and stack[-1].name == QUERY:
            out.append(s)
        stack.append(s)
    return out


def reduce(events: List) -> Dict:
    """Idle seconds by phase, and host and device seconds by span per
    batch, over the traced stretch; ``{}`` without ``bench.query``."""
    queries = sorted((e.start, e.end) for e in events
                     if not e.device and e.name == trace.QUERY)
    if not queries:
        return {}
    w0, w1 = queries[0][0], queries[-1][1]
    ctl = {e.thread for e in events if not e.device and e.name == trace.QUERY}
    dev = [e for e in events if e.device and e.end > w0 and e.start < w1]
    busy = trace._union([(max(e.start, w0), min(e.end, w1)) for e in dev])
    idle, prev = [], w0
    for s, e in busy + [(w1, w1)]:
        if s > prev:
            idle.append((prev, s))
        prev = max(prev, e)
    spans = sorted((e for e in events if not e.device and e.thread in ctl
                    and e.name.startswith(PREFIX)
                    and e.end > w0 and e.start < w1),
                   key=lambda e: (e.start, -e.end))
    calls = [(e.start, e.end) for e in spans if e.name == QUERY]
    phases = _phases(spans)
    # idle by label: cut the window at every boundary and label each piece
    cuts = sorted({w0, w1, *(t for iv in idle for t in iv),
                   *(t for iv in calls for t in iv),
                   *(t for p in phases for t in (p.start, p.end))})
    pspans = [(p.start, p.end) for p in phases]    # disjoint, sorted
    idle_by: Dict[str, float] = collections.defaultdict(float)
    for a, b in zip(cuts, cuts[1:]):
        mid = 0.5 * (a + b)
        if trace._which(mid, idle) < 0:
            continue
        i = trace._which(mid, pspans)
        label = (phases[i].name if i >= 0
                 else QUERY if trace._inside(mid, calls) else OUTSIDE)
        idle_by[label] += (b - a) * 1e-6
    n = len(queries)
    host: Dict[str, float] = collections.defaultdict(float)
    for s in spans:
        host[s.name] += (min(s.end, w1) - max(s.start, w0)) * 1e-6 / n
    starts = [s.start for s in spans]
    device: Dict[str, float] = collections.defaultdict(float)
    unlinked = 0
    for e in dev:
        if e.name.startswith(("Memcpy", "Memset")):
            continue
        launch = getattr(e, "launch", None)
        if launch is None:
            unlinked += 1
            continue
        s = _innermost(spans, starts, launch)
        device[s.name if s is not None else OUTSIDE] += \
            (e.end - e.start) * 1e-6 / n
    return {"batches": n, "window_s": (w1 - w0) * 1e-6,
            "idle_s": sum(b - a for a, b in idle) * 1e-6,
            "spans": len(spans), "idle_by_phase_s": dict(idle_by),
            "host_s_per_batch": dict(host),
            "device_s_per_batch": dict(device), "unlinked_kernels": unlinked}


def _pct(red: Dict, names: Tuple[str, ...]) -> Optional[float]:
    if not red.get("spans") or not red.get("window_s"):
        return None
    by = red["idle_by_phase_s"]
    return 100.0 * sum(by.get(k, 0.0) for k in names) / red["window_s"]


def readings(red: Dict, stats: Dict) -> Dict[str, Optional[float]]:
    """The per-layer readings of the spans (``reduce``) and of the index's
    ``index_stats()``; ``None`` where the program gives nothing to read."""
    host = red.get("host_s_per_batch") or {}
    device = red.get("device_s_per_batch") or {}
    q = (stats or {}).get("query") or {}
    delta = [v for k, v in device.items() if k.startswith("hlsh.delta.")]
    build = (stats or {}).get("build_seconds")
    return {
        "hash_idle_pct": _pct(red, ("hlsh.hash",)),
        "estimate_idle_pct": _pct(red, ("hlsh.estimate",)),
        "search_idle_pct": _pct(red, ("hlsh.search.lsh",
                                      "hlsh.search.linear")),
        "route_wait_ms": (1e3 * host["hlsh.route"] if "hlsh.route" in host
                          else None),
        "delta_device_ms": 1e3 * sum(delta) if delta else None,
        "program_syncs_per_batch": (q["syncs"] / q["batches"]
                                    if q.get("batches") else None),
        "index_build_s": float(build) if build else None,
    }
