"""One run of one cell: set-up, warm-up, the measured window, the traced
stretch, the check, and the result line.

Everything that belongs to a cell is found by name: ``BENCHMARK.json``
names the cell's configuration (``bench/configs/<name>.json``, whose
``system`` names ``bench/systems/<system>.py``), its traffic mix
(``bench/traffic/<mix>.json``), its check limits
(``bench/limits/<cell>.json``) and its per-layer metrics
(``bench/metrics/<metric>.py``, each with ``read(ctx)``).  The harness
keeps what every cell shares: the loop, warm-up, window and clock, the
traced stretch and the per-layer readers, the comparison against the
limits, and the result line.  What is particular to a cell (its data,
its requests, the program under test and how its answers are judged)
is the system module's.

Adding a configuration with new files only: write its configuration
file and its ``BENCHMARK.json`` entries, a traffic file (which names its
requests a round ``batch_queries``), a limits file, its size for the
CPU tests (``bench/tests/tiny/<config>.json``, shaped ``{"config":
{...}, "mix": {...}}``, whose keys replace the files' own; a
configuration without one fails its tests before any set-up) and, where
no existing module fits, ``bench/systems/<system>.py``.  A configuration
cut to fit lists each changed key in ``reduced``, as its
``BENCHMARK.json`` entry does, gives the source's value of each in
``published`` and says in ``deployment`` what share of the deployment
it is, for a depth cut such as ``"num_hidden_layers": 10,
"reduced": ["num_hidden_layers"], "published": {"num_hidden_layers":
40}, "deployment": "pipeline stage 1 of 4"``.  The harness loads the
system module by path from the root and asks it for:

- ``make_data(cfg, mix, dep, gen)``: the cell's data (weights, corpus,
  query pool, parameters), from the deployment's generator ``dep``
  (seeded by the configuration's ``deployment_seed``) and the run's
  ``gen`` (seeded by ``--seed``), both on the device.
- ``Traffic(mix, data, seed, device)``: ``.batch``, the requests a
  round; ``.next()``, the next round as (what ``System.query`` is
  handed, a key by which the check finds the round's requests);
  ``.live()``, the live set as it stands, handed to the check.
- ``System(cfg, data, device)``, the program under test:
  ``.query(request)``, the timed call, whose result is judged;
  ``.snapshot()``, what the check needs of the program's state when a
  round is kept; ``.counters()``, numbers by name, read after every
  window round (the per-layer readers see each as the list of its
  per-round values, ``ctx[name]``); ``.close()``, which frees the
  program's buffers and returns what the check may still use (such as
  the weights), or None.
- ``keep_traced(result, key)``: what the check keeps of a traced
  round's result (the result itself is dropped).
- ``check(cfg, data, judged, traced, control, left)``: ``judged`` holds
  (result, key, live, snapshot) of each judged round, ``traced`` (key,
  ``keep_traced``, live, snapshot) of each priced traced round, or None
  without ``--trace``; ``left`` is what ``close`` returned.  It returns
  a dict: ``compared``, the numbers that limits may hold, by name;
  ``judged``, the requests judged (a run with none is not correct);
  ``readings``, further numbers the per-layer readers see beside
  ``compared`` in ``ctx["checks"]``; ``info``, numbers for the ``info``
  line; ``control``, the control's numbers (None unless ``control``);
  ``work``, work counts for the per-layer readers (``ctx["work"]``).

Every key of the cell's limits file is compared, value <= limit, and a
run is correct when each holds and ``judged`` > 0; a key that the check
does not return makes the run raise, with no result line.
"""
from __future__ import annotations

import collections
import gc
import importlib.util
import json
import os
import random
import statistics
import sys
import time
from pathlib import Path
from typing import Dict, Optional

import torch

from bench.lib import trace as trace_lib

JUDGED_BATCHES = 4       # rounds the check judges, drawn from the seed
TRACE_ROUNDS = 16        # rounds in the traced stretch
WORK_EVERY = 8           # the check prices every 8th traced round
WARM_ROUNDS = 8
WARM_SECONDS = 1.0       # and at least this long, so clocks and caches settle
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


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
    """A metric reader or system module, from its file."""
    name = f"bench_{path.parent.name}_" + path.stem.replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod         # as an import would: dataclasses look it up
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


class Run:
    """One run's state: ``run_cell`` calls setup, warm_up, window, the
    traced stretch and check in that order."""

    def __init__(self, root: Path, name: str, seed: int, seconds: float,
                 trace: bool, device, overrides: Optional[Dict] = None,
                 control: bool = False):
        self.seed = int(seed)
        self.seconds, self.trace = float(seconds), bool(trace)
        self.device = torch.device(device)
        self.root = Path(root)
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
        self.sysmod = load_module(self.root / "bench" / "systems"
                                  / f"{self.cfg['system']}.py")
        self.data = self.sysmod.make_data(self.cfg, self.mix, dep, gen)
        self.system = self.sysmod.System(self.cfg, self.data, self.device)
        self.traffic = self.sysmod.Traffic(self.mix, self.data, self.seed,
                                           self.device)

    def round(self, record=None, spans: bool = False):
        """One round.  Returns (round seconds, result, key, live set)."""
        from torch.profiler import record_function
        req, key = self.traffic.next()
        live = self.traffic.live()
        _sync(self.device)
        t0 = time.perf_counter()
        if spans:
            with record_function(trace_lib.QUERY):
                with record_function(trace_lib.CALL):
                    res = self.system.query(req)
                _sync(self.device)
        else:
            res = self.system.query(req)
            _sync(self.device)
        t1 = time.perf_counter()
        if record is not None:
            record(res, key, live)
        return t1 - t0, res, key, live

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

        def keep(res, key, live):
            seen[0] += 1
            i = seen[0]
            slot = len(kept) if len(kept) < JUDGED_BATCHES else rng.randrange(i)
            if slot < JUDGED_BATCHES:
                item = (res, key, live, self.system.snapshot())
                if slot == len(kept):
                    kept.append(item)
                else:
                    kept[slot] = item

        self.batch_s, self.round_counters = [], []
        self.t_open = time.perf_counter()
        while True:
            tb, res, _, _ = self.round(record=keep)
            del res
            self.batch_s.append(tb)
            self.round_counters.append(self.system.counters())
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

        def note(res, key, live):
            rounds.append((key, self.sysmod.keep_traced(res, key), live,
                           self.system.snapshot()))

        with profile(activities=acts) as prof:
            for _ in range(TRACE_ROUNDS):
                self.round(record=note, spans=True)
            _sync(self.device)
        self.trace_rounds = rounds
        self.trace_summary = trace_lib.reduce(trace_lib.collect(prof))

    # ------------------------------------------------------------- check
    def check(self, left) -> Dict:
        """The system's check of the judged rounds (and, traced, of every
        ``WORK_EVERY``-th traced round); ``left`` is what ``close`` left."""
        traced = (self.trace_rounds[WORK_EVERY - 1::WORK_EVERY]
                  if self.trace else None)
        kept, self.kept = self.kept, None
        return self.sysmod.check(self.cfg, self.data, kept, traced,
                                 self.control, left)


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
    left = run.system.close()
    run.system = None
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    n_batches = len(run.batch_s)
    window_s = run.t_close - run.t_open
    nq = n_batches * run.traffic.batch
    t = time.perf_counter()
    chk = run.check(left)
    del left
    phases["reference_s"] = time.perf_counter() - t
    missing = sorted(set(run.spec["limits"]) - set(chk["compared"]))
    if missing:
        raise KeyError(f"limits {missing} of {name!r} name no number that "
                       f"the {run.cfg['system']!r} check returns")
    compared = {k: {"value": chk["compared"][k], "limit": float(v)}
                for k, v in run.spec["limits"].items()}
    correct = (chk["judged"] > 0
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
        ctx = {"trace": ts, "work": chk["work"],
               "checks": {**chk["compared"], **chk["readings"]},
               "work_device_s": dict(priced),
               **{k: [c[k] for c in run.round_counters] for k in counters},
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
            "warm_rounds": run.warm_rounds, **phases, **chk["info"],
            **counters}
    print("info " + json.dumps(info), file=err)
    if chk["control"] is not None:
        print("control " + json.dumps(chk["control"]), file=err)
        result["control"] = chk["control"]
    for k, v in compared.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=err)
    result["checks"] = compared
    return result
