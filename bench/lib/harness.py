"""One run of one cell: set-up, warm-up, the measured window, the traced
stretch, the reference's check, and the result line.

Everything that belongs to a cell is found by name: ``BENCHMARK.json``
names the cell's configuration (``bench/configs/<name>.json``, whose
``system`` names ``bench/systems/<system>.py``), its traffic mix
(``bench/traffic/<mix>.json``), its check limits
(``bench/limits/<cell>.json``) and its per-layer metrics
(``bench/metrics/<metric>.py``, each with ``read(ctx)``).
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import random
import statistics
import sys
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from bench.lib import trace as trace_lib
from bench.lib.data import make_data
from bench.lib.traffic import Traffic
from bench.reference import judge as judge_lib
from bench.reference import lsh

JUDGED_BATCHES = 4       # query batches the reference checks, drawn from the seed
TRACE_ROUNDS = 16        # rounds in the traced stretch
WORK_EVERY = 8           # the reference prices every 8th traced round
WARM_ROUNDS = 8
WARM_SECONDS = 1.0       # and at least this long, so clocks and caches settle
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
CHECKS = ("report_gap", "distance_gap", "route_gap", "collision_excess",
          "estimate_gap", "state_mismatch")
ANSWER_CHECKS = CHECKS[:5]     # the numbers ``judge`` gives


def process_age() -> float:
    """Seconds since this process started (from /proc), else 0."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


PROCESS_T0 = time.perf_counter() - process_age()


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(root: Path, name: str) -> Dict:
    """The cell's entry, configuration, mix, limits and metrics."""
    bench = load_json(root / "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name])
                 and m["moves"] in names]
    return {"cell": cell,
            "config": load_json(root / conf["file"]),
            "mix": load_json(root / "bench" / "traffic"
                             / f"{cell['traffic']}.json"),
            "limits": load_json(root / "bench" / "limits" / f"{name}.json"),
            "end_to_end": e2e, "per_layer": per_layer}


def p95(values) -> float:
    if len(values) < 2:
        return float(values[0]) if values else float("nan")
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _routes(res, nq: int) -> np.ndarray:
    use = np.zeros(nq, bool)
    use[np.asarray(res.lsh_idx, np.int64)] = True
    return use


def _answer(res) -> judge_lib.Answer:
    """The port's ``QueryResult`` as the judge reads it."""
    pq, pe, pd = [], [], []
    for idx, grp in ((res.lsh_idx, res.lsh_out), (res.lin_idx, res.lin_out)):
        if grp is None:
            continue
        ids, dists, mask = grp
        qi, col = torch.nonzero(mask, as_tuple=True)
        sel = torch.as_tensor(np.asarray(idx, np.int64), device=ids.device)
        pq.append(sel[qi])
        pe.append(ids[qi, col].to(torch.int64))
        pd.append(dists[qi, col])
    rt = res.route
    return judge_lib.Answer(rt.use_lsh.to(torch.bool), rt.collisions,
                            rt.cand_est, torch.cat(pq), torch.cat(pe),
                            torch.cat(pd))


class Run:
    """One run's state: ``run_cell`` calls setup, warm_up, window, the
    traced stretch and reference in that order."""

    def __init__(self, root: Path, name: str, seed: int, seconds: float,
                 trace: bool, device, overrides: Optional[Dict] = None,
                 control: bool = False):
        self.seed = int(seed)
        self.seconds, self.trace = float(seconds), bool(trace)
        self.device = torch.device(device)
        self.spec = cell_spec(root, name)
        for key, over in (overrides or {}).items():
            self.spec[key] = {**self.spec[key], **over}
        self.cfg, self.mix = self.spec["config"], self.spec["mix"]
        self.control = control

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        dep = torch.Generator(device=self.device).manual_seed(
            int(self.cfg["deployment_seed"]))
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.data = make_data(self.cfg, self.mix, dep, gen)
        self.params = lsh.draw_params(self.cfg, self.data.r, dep)
        mod = importlib.import_module(f"bench.systems.{self.cfg['system']}")
        self.system = mod.System(self.cfg, self.data, self.params,
                                 self.device)
        self.traffic = Traffic(self.mix, self.data, self.seed, self.device)

    def round(self, record=None, spans: bool = False):
        """One query batch.  Returns (batch seconds, result, query ids,
        live test)."""
        from torch.profiler import record_function
        idx = self.traffic.next_queries()
        q = self.data.queries[idx]
        live = self.traffic.live()
        _sync(self.device)
        t0 = time.perf_counter()
        if spans:
            with record_function(trace_lib.QUERY):
                with record_function(trace_lib.CALL):
                    res = self.system.query(q)
                _sync(self.device)
        else:
            res = self.system.query(q)
            _sync(self.device)
        t1 = time.perf_counter()
        if record is not None:
            record(res, idx, live)
        return t1 - t0, res, idx, live

    def warm_up(self) -> None:
        """Every shape of the cell once, and as many results held at once
        as the window will hold."""
        held = []
        n = 0
        t0 = time.perf_counter()
        while n < WARM_ROUNDS or time.perf_counter() - t0 < WARM_SECONDS:
            _, res, _, _ = self.round()
            held.append(res)
            held = held[-(JUDGED_BATCHES + 1):]
            n += 1
        del held
        self.warm_rounds = n
        _sync(self.device)

    # ------------------------------------------------------------ window
    def window(self) -> None:
        rng = random.Random(f"judged-{self.seed}")
        kept = []
        seen = [0]

        def keep(res, idx, live):
            seen[0] += 1
            i = seen[0]
            slot = len(kept) if len(kept) < JUDGED_BATCHES else rng.randrange(i)
            if slot < JUDGED_BATCHES:
                item = (res, idx, live, self.system.snapshot())
                if slot == len(kept):
                    kept.append(item)
                else:
                    kept[slot] = item

        self.batch_s, self.segments = [], []
        self.t_open = time.perf_counter()
        while True:
            tb, res, _, _ = self.round(record=keep)
            del res
            self.batch_s.append(tb)
            self.segments.append(self.system.counters()["segments"])
            t = time.perf_counter()
            if t - self.t_open >= self.seconds:
                break
        self.t_close = t
        self.kept = kept

    def traced_stretch(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        rounds = []

        def note(res, idx, live):
            rounds.append((idx, _routes(res, idx.shape[0]), live,
                           self.system.snapshot()))

        with profile(activities=acts) as prof:
            for _ in range(TRACE_ROUNDS):
                self.round(record=note, spans=True)
            _sync(self.device)
        self.trace_rounds = rounds
        self.trace_summary = trace_lib.reduce(trace_lib.collect(prof))

    # ------------------------------------------------------------- check
    def reference(self) -> Dict:
        """The judged batches held to the reference (and, for the control,
        the reference in the program's place at the lower precision);
        the per-layer work counts of the traced rounds."""
        cfg, data = self.cfg, self.data
        bank = data.corpus
        bh = lsh.bucket_ids(cfg, self.params, bank, data.r)
        ctl_bh = (lsh.bucket_ids(cfg, self.params, bank, data.r, "tf32")
                  if self.control else None)

        def state(snap, hashes):
            segs, n_scan, _ = snap.layout()
            return judge_lib.RefState(segs, bank, hashes, cfg, n_scan)

        out = {k: 0.0 for k in CHECKS}
        out.update(judged_queries=0, pairs_due=0, pairs_reported=0,
                   misrouted=0, doubtful_queries=0)
        ctl = {k: 0.0 for k in ANSWER_CHECKS}
        for res, idx, live, snap in self.kept:
            qv = data.queries[idx]
            qh = lsh.bucket_ids(cfg, self.params, qv, data.r)
            st = state(snap, bh)
            got = judge_lib.judge(st, qv, qh, live, data.r,
                                  _answer(res))
            for k in ANSWER_CHECKS:
                out[k] = max(out[k], got[k])
            out["judged_queries"] += got["queries"]
            for k in ("pairs_due", "pairs_reported", "misrouted",
                      "doubtful_queries"):
                out[k] += got[k]
            held = snap.live_ext()
            uniq = torch.unique(held)
            out["state_mismatch"] = max(out["state_mismatch"], float(
                live.mismatch(uniq) + held.numel() - uniq.numel()
                + snap.layout()[2]))
            if self.control:
                qc = lsh.bucket_ids(cfg, self.params, qv, data.r, "tf32")
                cans = judge_lib.control_answer(state(snap, ctl_bh), qv, qc,
                                                live, data.r)
                cgot = judge_lib.judge(st, qv, qh, live, data.r, cans)
                for k in ANSWER_CHECKS:
                    ctl[k] = max(ctl[k], cgot[k])
                # only the distances below the configuration's precision
                dans = judge_lib.control_answer(st, qv, qh, live, data.r)
                dgot = judge_lib.judge(st, qv, qh, live, data.r, dans)
                for k in ANSWER_CHECKS:
                    key = k + "_distances_only"
                    ctl[key] = max(ctl.get(key, 0.0), dgot[k])
                # the route's own fault: the control with every route flipped
                flip = judge_lib.judge(st, qv, qh, live, data.r,
                                       dataclasses.replace(
                                           cans, use_lsh=~cans.use_lsh))
                ctl["route_gap_flipped"] = max(
                    ctl.get("route_gap_flipped", 0.0), flip["route_gap"])
            del st, res
        self.kept = None
        out["misroute_pct"] = 100.0 * out["misrouted"] / max(
            out["judged_queries"], 1)
        work = None
        if self.trace:
            work = {}
            for idx, use, live, snap in self.trace_rounds[WORK_EVERY - 1::
                                                          WORK_EVERY]:
                qv = data.queries[idx]
                qh = lsh.bucket_ids(cfg, self.params, qv, data.r)
                w = judge_lib.batch_work(
                    state(snap, bh), qv, qh, live, data.r,
                    torch.as_tensor(use, device=qv.device))
                for k, v in w.items():
                    work[k] = v if k in ("d", "L", "m") else work.get(k, 0) + v
            work = work or None
        return {"checks": out, "control": ctl if self.control else None,
                "work": work}


def forbidden_modules():
    """Top-level names of loaded modules that this run must not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             device, overrides: Optional[Dict] = None, control: bool = False,
             err=sys.stderr) -> Dict:
    """A whole run; returns the result (the last line's object).  Raises
    where the run cannot give one."""
    run = Run(root, name, seed, seconds, trace, device, overrides, control)
    phases = {}
    t = time.perf_counter()
    run.setup()
    phases["build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    run.warm_up()
    phases["warm_s"] = time.perf_counter() - t
    run.window()
    setup_s = run.t_open - PROCESS_T0
    if trace:
        t = time.perf_counter()
        run.traced_stretch()
        phases["trace_s"] = time.perf_counter() - t
    counters = run.system.counters()
    peak = (torch.cuda.max_memory_allocated(run.device)
            if run.device.type == "cuda" else 0)
    run.system.close()
    run.system = None
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    n_batches = len(run.batch_s)
    window_s = run.t_close - run.t_open
    nq = n_batches * run.traffic.batch
    t = time.perf_counter()
    ref = run.reference()
    phases["reference_s"] = time.perf_counter() - t
    checks = ref["checks"]
    limits = run.spec["limits"]
    compared = {k: {"value": checks[k], "limit": float(limits[k])}
                for k in CHECKS if k in limits}
    correct = (checks["judged_queries"] > 0
               and all(v["value"] <= v["limit"] for v in compared.values()))
    values = {"queries_per_s": nq / window_s,
              "batch_p95_ms": 1e3 * p95(run.batch_s),
              "setup_s": setup_s}
    device_info = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(run.device)
                            if run.device.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct),
              "attempted": nq, "failed": 0}
    if trace:
        ts = run.trace_summary
        priced = collections.defaultdict(float)
        for d in ts.get("round_device_s", [])[WORK_EVERY - 1::WORK_EVERY]:
            for k, v in d.items():
                priced[k] += v
        ctx = {"trace": ts, "work": ref["work"], "checks": checks,
               "work_device_s": dict(priced),
               "segments": run.segments,
               "config": run.cfg, "mix": run.mix}
        metrics = {}
        for m in run.spec["per_layer"]:
            mod = load_module(root / "bench" / "metrics" / f"{m['name']}.py")
            v = mod.read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        device_info.update(busy_s=ts.get("busy_s", 0.0),
                           window_s=ts.get("window_s", 0.0))
        result["metrics"] = metrics
        result["device"] = device_info
        result["breakdown"] = ts.get("breakdown", {})
    else:
        result["metrics"] = {m["name"]: {"value": float(values[m["name"]]),
                                         "unit": m["unit"]}
                             for m in run.spec["end_to_end"]}
        result["device"] = device_info
    info = {"batches": n_batches, "window_s": window_s,
            "warm_rounds": run.warm_rounds, "radius": run.data.r, **phases,
            **{k: checks[k] for k in ("judged_queries", "pairs_due",
                                      "pairs_reported", "doubtful_queries",
                                      "misroute_pct")},
            **counters}
    print("info " + json.dumps(info), file=err)
    if ref["control"] is not None:
        print("control " + json.dumps(ref["control"]), file=err)
        result["control"] = ref["control"]
    for k, v in compared.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=err)
    result["checks"] = compared
    return result
