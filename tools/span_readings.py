#!/usr/bin/env python3
"""The program-span readings of one benchmark cell, and what a span costs.

    python3 tools/span_readings.py --workload covertype.read --seed 7
    python3 tools/span_readings.py --span-cost

The first form runs the cell as ``bench/run.py`` does (set-up, warm-up, a
short window) and then its traced stretch (``harness.TRACE_ROUNDS``
rounds under ``torch.profiler``), keeps the stretch's events and prints
one JSON line: the readings of ``bench/lib/spans.py`` (idle by phase,
host and device time by ``hlsh.*`` span, the index's ``index_stats()``,
the batches the bucket hash kernel hashed, the LSH groups K2 verified in
one launch a segment, and the batches whose delta counts launched the
collision test kernel or met an empty delta, beside them)
beside the benchmark's own trace metrics (``device_idle_pct``,
``launches_per_batch``, ``syncs_per_batch``), the traced rounds' mean
batch time, and each host wait of the index call with the span and the
host op it sits in.  On a tree whose program opens no ``hlsh.*`` span the
span readings are null.

``--span-cost`` prints the host microseconds of one ``span()`` (and of a
``record_function``) with no profiler and under a profiler tracing the
CPU and CUDA, and which ``hlsh.*`` names the profiler copies onto the
device timeline.  Both forms need a CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def span_cost(n_off: int = 200_000, n_on: int = 20_000) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.obs.spans import span

    def per(n, enter):
        t0 = time.perf_counter()
        for _ in range(n):
            with enter("hlsh.cost"):
                pass
        return 1e6 * (time.perf_counter() - t0) / n

    x = torch.ones(1024, device="cuda")
    out = {"span_off_us": per(n_off, span),
           "record_function_off_us": per(n_off // 10, record_function)}
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        out["span_on_us"] = per(n_on, span)
        out["record_function_on_us"] = per(n_on, record_function)
    with profile(activities=acts) as prof:
        with span("hlsh.probe.span"):
            x.add_(1)
        with record_function("hlsh.probe.record_function"):
            x.add_(1)
        torch.cuda.synchronize()
    out["device_copies"] = sorted({
        e.name for e in prof.events()
        if e.name.startswith("hlsh.probe")
        and e.device_type != torch.autograd.DeviceType.CPU})
    return out


def syncs_by_site(events, calls):
    """Host waits inside the index calls, by (innermost ``hlsh.*`` span,
    innermost other host op) around them."""
    from bench.lib import trace
    ctl = {e.thread for e in events if not e.device
           and e.name == trace.QUERY}
    host = [e for e in events if not e.device and e.thread in ctl]
    out = collections.Counter()
    for w in host:
        if w.name not in trace.SYNC_NAMES or not trace._inside(w.start,
                                                                 calls):
            continue
        around = [e for e in host if e is not w and e.start <= w.start
                  and e.end >= w.end and e.name not in trace.SPANS]
        sp = max((e for e in around if e.name.startswith("hlsh.")),
                 key=lambda e: e.start, default=None)
        op = max((e for e in around if not e.name.startswith("hlsh.")),
                 key=lambda e: e.start, default=None)
        out[f"{sp.name if sp else '-'} / {op.name if op else '-'}"] += 1
    return dict(out)


def cell(workload: str, seed: int, seconds: float) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bench.lib import harness
    from bench.lib import spans as spans_lib
    from bench.lib import trace

    torch.set_num_threads(2)
    run = harness.Run(ROOT, workload, seed, seconds, True, "cuda")
    run.setup()
    run.warm_up()
    run.window()
    batch_s = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(harness.TRACE_ROUNDS):
            batch_s.append(run.round(spans=True)[0])
        torch.cuda.synchronize()
    events = spans_lib.collect(prof)
    ts = trace.reduce(events)
    red = spans_lib.reduce(events)
    index = getattr(run.system, "index", None)
    stats = index.index_stats() if hasattr(index, "index_stats") else {}
    calls = sorted((e.start, e.end) for e in events
                   if not e.device and e.name == trace.CALL)
    busy = ts["busy_s"] / ts["window_s"]
    return {
        "workload": workload, "seed": seed,
        "window_queries_per_s": (len(run.batch_s) * run.traffic.batch
                                 / (run.t_close - run.t_open)),
        "traced_batch_ms_mean": 1e3 * statistics.fmean(batch_s),
        "device_idle_pct": 100.0 * (1.0 - busy),
        "launches_per_batch": ts["launches"] / ts["batches"],
        "syncs_per_batch": ts["syncs"] / ts["batches"],
        "readings": spans_lib.readings(red, stats),
        # beside the hash's readings: the index's batches whose bucket ids
        # the bucket hash kernel made, of all it answered (None on a tree
        # without the kernel); beside ``delta_device_ms``: its batches
        # whose delta counts launched the collision test kernel, and
        # those that met an empty delta (None on a tree without them)
        "hash_kernel_batches": (stats.get("query") or {}).get(
            "hash_kernel_batches"),
        # beside ``hlsh.search.lsh``: the LSH groups whose segments K2
        # verified in one launch each (None on a tree without the count)
        "lsh_kernel_groups": (stats.get("query") or {}).get(
            "lsh_kernel_groups"),
        "delta_kernel_batches": stats.get("delta_kernel_batches"),
        "delta_empty_batches": stats.get("delta_empty_batches"),
        "spans": red,
        "stats_query": stats.get("query"),
        "syncs_by_site": syncs_by_site(events, calls),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--span-cost", action="store_true")
    a = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    out = span_cost() if a.span_cost else cell(a.workload, a.seed, a.seconds)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
