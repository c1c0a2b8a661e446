"""Reduction of a ``torch.profiler`` trace of the traced stretch.

The harness marks each round with its own ranges (``record_function``):
``bench.query`` around a query batch and the synchronise that ends it,
``bench.call`` around the index call alone.  Each batch starts after the
previous one's synchronise, so the device work of a batch runs inside
its ``bench.query`` range.

From the trace: the union of device activity over the stretch (busy and
idle), device time by kernel name, kernels and host waits per query
batch, and the idle gaps labelled by what the control thread's host
code was doing then.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Tuple

QUERY, CALL = "bench.query", "bench.call"
SPANS = (QUERY, CALL)
# host calls that wait for the device
SYNC_NAMES = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


@dataclasses.dataclass
class Event:
    name: str
    device: bool      # ran on the device (kernel, copy, set)
    start: float      # microseconds, one clock for host and device
    end: float
    thread: int = 0


def collect(prof) -> List[Event]:
    """The trace's events, host and device, as ``Event``s.  The device
    copies of the benchmark's own ranges (the profiler's GPU user
    annotations) are not device work and are left out."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.events():
        tr = e.time_range
        dev = e.device_type != DeviceType.CPU
        if dev and e.name in SPANS:
            continue
        out.append(Event(e.name, dev, float(tr.start), float(tr.end),
                         int(getattr(e, "thread", 0) or 0)))
    return out


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _which(t: float, spans: List[Tuple[float, float]]) -> int:
    """Index of the (sorted, disjoint) span holding t, else -1."""
    import bisect
    i = bisect.bisect_right(spans, (t, float("inf"))) - 1
    return i if i >= 0 and spans[i][0] <= t <= spans[i][1] else -1


def _inside(t: float, spans: List[Tuple[float, float]]) -> bool:
    return _which(t, spans) >= 0


def reduce(events: List[Event]) -> Dict:
    """Busy and window seconds, device seconds by name, per-batch counts,
    and the top-10 breakdown lists."""
    spans = collections.defaultdict(list)
    for e in events:
        if not e.device and e.name in SPANS:
            spans[e.name].append((e.start, e.end))
    for v in spans.values():
        v.sort()
    queries = spans[QUERY]
    if not queries:
        return {}
    w0, w1 = queries[0][0], queries[-1][1]
    ctl = {e.thread for e in events if not e.device and e.name == QUERY}
    dev = [e for e in events if e.device and e.name not in SPANS
           and e.end > w0 and e.start < w1]
    busy_iv = _union([(max(e.start, w0), min(e.end, w1)) for e in dev])
    busy = sum(e - s for s, e in busy_iv)
    by_name: Dict[str, float] = collections.defaultdict(float)
    for e in dev:
        by_name[e.name] += (min(e.end, w1) - max(e.start, w0)) * 1e-6
    kernels = [e for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
    per_round = [collections.defaultdict(float) for _ in queries]
    launches = 0
    for e in kernels:
        i = _which(e.start, queries)
        if i >= 0:
            launches += 1
            per_round[i][e.name] += (e.end - e.start) * 1e-6
    calls = spans[CALL]
    host = sorted((e for e in events if not e.device and e.thread in ctl
                   and e.name not in SPANS), key=lambda e: e.start)
    starts = [e.start for e in host]
    syncs = sum(1 for e in host if e.name in SYNC_NAMES
                and _inside(e.start, calls))
    if not any(e.name in SYNC_NAMES for e in host):
        syncs = sum(1 for e in host if e.name == "aten::_local_scalar_dense"
                    and _inside(e.start, calls))
    gaps: Dict[str, float] = collections.defaultdict(float)
    prev = w0
    for s, e in busy_iv + [(w1, w1)]:
        if s > prev:
            mid = 0.5 * (prev + s)
            gaps[_label(host, starts, spans, mid)] += (s - prev) * 1e-6
        prev = max(prev, e)
    top = lambda d: [[k, v] for k, v in sorted(  # noqa: E731
        d.items(), key=lambda kv: -kv[1])[:10]]
    return {"busy_s": busy * 1e-6, "window_s": (w1 - w0) * 1e-6,
            "batches": len(queries), "launches": launches, "syncs": syncs,
            "device_s_by_name": dict(by_name),
            "round_device_s": [dict(d) for d in per_round],
            "breakdown": {"device_ops": top(by_name), "idle_gaps": top(gaps)}}


def _label(host: List[Event], starts: List[float], spans, t: float) -> str:
    """What the host was doing at time t: the innermost host event that
    covers it (the latest-starting one; ``host`` sorted by start), under
    the benchmark range it falls in."""
    import bisect
    where = next((n for n in (CALL, QUERY) if _inside(t, spans[n])),
                 "between rounds")
    inner = None
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 4096, -1), -1):
        if host[j].end >= t:
            inner = host[j]
            break
    return f"{where}: {inner.name if inner else 'python'}"


def kernel_seconds(by_name: Dict[str, float], names) -> float:
    """Device seconds of the kernels whose name contains any of ``names``."""
    return sum(s for k, s in by_name.items() if any(n in k for n in names))
