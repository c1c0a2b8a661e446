#!/usr/bin/env python3
"""Profile the query phases of one tree's port on the card, so that two
trees (a parent unpacked with ``git archive`` and this one) can be set side
by side in one call.

  python3 tools/phase_profile.py --src SRC_DIR --label NAME

imports ``repro_torch`` from SRC_DIR (its ``src`` directory) and builds
the indexes ``chip_smoke.py`` drives, at full scale:

  * the MNIST analogue's static index (59,900 64-bit codes, Hamming,
    L = 20, B = 16,384) at the radii q2 and q3 of chip_smoke.py's rule;
  * a churned MNIST streaming index: built on 32,768 rows, the other
    27,132 inserted in batches of 2,048 through a 4,096-row delta (merges
    drained synchronously), 1 % of the ids deleted; queried at q3;
  * a churned CoverType streaming index (L1, d = 54): built on 524,288
    rows, 56,624 inserted in batches of 4,096 through an 8,192-row delta,
    1 % deleted; queried at q3.

For each index it traces 3 calls each of ``estimate()``, ``query(force=
"linear")`` and ``query()`` (the hybrid) with ``torch.profiler`` and
prints one JSON line per (index, phase): device ms per call, device
kernels per call (all of them, concatenations, index / gather kernels,
``where``s), the six kernels that take most device time, and the median
host-clock ms of 5 synchronised calls.  It reads only the public API that
both trees have.  A run takes about a minute on an H100.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time


def census(dev, reps):
    """Device kernels per call in ``torch.profiler`` events ``dev`` of
    ``reps`` calls: all of them, and the concatenations, index / gather
    kernels and ``where``s among them."""
    def count(pred):
        return sum(e.count for e in dev if pred(e.key)) / reps
    return {"all": count(lambda k: True),
            "cat": count(lambda k: "CatArray" in k),
            "index/gather": count(lambda k: "index" in k.lower()
                                  or "gather" in k.lower()),
            "where": count(lambda k: "where" in k.lower())}


def phase(torch, fn, reps=3):
    """Device ms, kernel census and top kernels per call of ``fn`` under
    torch.profiler, and the host-clock median of 5 synchronised calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    host = []
    for _ in range(5):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    return {"device_ms": sum(e.self_device_time_total for e in dev) / reps / 1e3,
            "host_ms": statistics.median(host),
            "kernels": census(dev, reps),
            "top": [[e.key[:60], e.count / reps,
                     e.self_device_time_total / reps / 1e3] for e in top]}


def radii(x, metric):
    """chip_smoke.py's radii: quantiles 0.0005, 0.005, 0.03, 0.12 of the
    distances of 2,000 random pairs."""
    import numpy as np
    rng = np.random.default_rng(0)
    a = x[rng.integers(0, len(x), 2000)]
    b = x[rng.integers(0, len(x), 2000)]
    if metric == "hamming":
        d = np.unpackbits((a ^ b).view(np.uint8), axis=1).sum(1)
    else:
        d = np.abs(a - b).sum(1)
    return [float(v) for v in np.quantile(d, [0.0005, 0.005, 0.03, 0.12])]


def churn(idx, x, n_build, batch, seed):
    import numpy as np
    for lo in range(n_build, len(x), batch):
        idx.insert(x[lo:lo + batch])
    rng = np.random.default_rng(seed)
    idx.delete(rng.choice(len(x), len(x) // 100, replace=False).tolist())
    return idx


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True)
    ap.add_argument("--label", required=True)
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch
    if not torch.cuda.is_available():
        print("phase_profile: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core import PAPER_PRESETS, HybridLSHIndex
    from repro_torch.core.lsh import make_family
    from repro_torch.data import paper_dataset, query_split
    from repro_torch.streaming import CompactionPolicy, DynamicHybridIndex
    import repro_torch
    print(f"[{args.label}] repro_torch from {repro_torch.__file__}; "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    def emit(index, name, rec):
        print(json.dumps({"tree": args.label, "index": index, "phase": name,
                          **rec}), flush=True)

    def profile(index, idx, q, r):
        emit(index, "estimate", phase(torch, lambda: idx.estimate(q)))
        emit(index, "linear", phase(torch, lambda: idx.query(q, r,
                                                             force="linear")))
        emit(index, "hybrid", phase(torch, lambda: idx.query(q, r)))

    x, metric = paper_dataset("mnist", scale=1.0, seed=0)
    x, q = query_split(x, n_queries=100, seed=0)
    rs = radii(x, metric)
    kw = dict(num_buckets=16384, m=64, cap=256,
              cost_model=PAPER_PRESETS["mnist"], device="cuda")
    for i in (2, 3):
        fam = make_family("hamming", d=64, L=20, r=rs[i], delta=0.1)
        profile(f"mnist q{i} static", HybridLSHIndex(fam, seed=0, **kw).build(x),
                q, rs[i])
    fam = make_family("hamming", d=64, L=20, r=rs[3], delta=0.1)
    dyn = churn(DynamicHybridIndex(fam, seed=0, delta_capacity=4096,
                                   policy=CompactionPolicy(), **kw)
                .build(x[:32768]), x, 32768, 2048, seed=2)
    profile(f"mnist q3 churned ({len(dyn.stack.segments)} frozen segments)",
            dyn, q, rs[3])
    del dyn

    x, metric = paper_dataset("covertype", scale=1.0, seed=0)
    x, q = query_split(x, n_queries=100, seed=0)
    rs = radii(x, metric)
    fam = make_family("l1", d=54, L=20, r=rs[3], delta=0.1)
    dyn = churn(DynamicHybridIndex(
        fam, seed=0, num_buckets=65536, m=64, cap=256, delta_capacity=8192,
        cost_model=PAPER_PRESETS["covertype"], policy=CompactionPolicy(),
        device="cuda").build(x[:524288]), x, 524288, 4096, seed=1)
    profile(f"covertype q3 churned ({len(dyn.stack.segments)} frozen "
            f"segments)", dyn, q, rs[3])
    return 0


if __name__ == "__main__":
    sys.exit(main())
