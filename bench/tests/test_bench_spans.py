"""``bench/lib/spans.py``: the device copies of the program's ranges stay
out of the device work, the idle put down to the phases adds up to the
idle of ``device_idle_pct``, kernels land in the span that launched them,
and a real traced stretch of the port on the CPU reduces as it should."""
import dataclasses
import types

import pytest

from bench.tests import _tiny
from bench.lib import spans as spans_lib
from bench.lib import trace

CPU, GPU = "cpu", "cuda"


@dataclasses.dataclass
class Fake:
    """What ``collect`` reads of a profiler event."""
    name: str
    where: str
    start: float
    end: float
    id: int = 0
    thread: int = 1

    @property
    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CPU if self.where == CPU else DeviceType.CUDA

    @property
    def time_range(self):
        return types.SimpleNamespace(start=self.start, end=self.end)


def _prof(events):
    return types.SimpleNamespace(events=lambda: list(events))


def _batch(t, delta=False):
    """One round from t (microseconds): host ranges and, in the device's
    timeline, a kernel per phase launched inside it, plus the device
    copies the profiler makes of user ranges."""
    ev = [Fake("bench.query", CPU, t, t + 100), Fake("bench.call", CPU, t, t + 90),
          Fake("hlsh.query", CPU, t + 1, t + 89),
          Fake("hlsh.hash", CPU, t + 2, t + 10),
          Fake("hlsh.estimate", CPU, t + 12, t + 30),
          Fake("hlsh.route", CPU, t + 31, t + 40),
          Fake("hlsh.search.lsh", CPU, t + 42, t + 80)]
    k = [("hash_kernel", t + 3, t + 8, t + 12), ("est_kernel", t + 14, t + 20, t + 31),
         ("scan_kernel", t + 44, t + 50, t + 95)]
    if delta:
        ev.append(Fake("hlsh.delta.counts", CPU, t + 15, t + 25))
        k.append(("any_kernel", t + 16, t + 31, t + 36))
    for i, (name, launch, s, e) in enumerate(k):
        cid = int(t) * 10 + i + 1
        ev += [Fake("cudaLaunchKernel", CPU, launch, launch + 1, id=cid),
               Fake(name, GPU, s, e, id=cid)]
    ev.append(Fake("cudaStreamSynchronize", CPU, t + 96, t + 99))
    # device copies of the ranges: not device work
    ev += [Fake("bench.query", GPU, t + 12, t + 95),
           Fake("hlsh.query", GPU, t + 12, t + 95),
           Fake("hlsh.search.lsh", GPU, t + 50, t + 95)]
    return ev


def _events(delta=False):
    return [e for t in (0.0, 200.0, 400.0) for e in _batch(t, delta)]


def test_collect_leaves_out_the_program_ranges_device_copies():
    raw = _events()
    ours = trace.reduce(spans_lib.collect(_prof(raw)))
    plain = [e for e in raw if not (e.where == GPU
                                    and e.name.startswith("hlsh."))]
    parent = trace.reduce(trace.collect(_prof(plain)))
    for k in ("launches", "busy_s", "window_s", "syncs", "breakdown"):
        assert ours[k] == parent[k], k
    assert ours["launches"] == 9
    # the unfiltered copies would count as kernels and as busy time
    polluted = trace.reduce(trace.collect(_prof(raw)))
    assert polluted["launches"] > ours["launches"]
    assert polluted["busy_s"] > ours["busy_s"]


@pytest.mark.parametrize("delta", [False, True])
def test_idle_by_phase_adds_up_to_the_device_idle(delta):
    events = spans_lib.collect(_prof(_events(delta)))
    ts, red = trace.reduce(events), spans_lib.reduce(events)
    idle = ts["window_s"] - ts["busy_s"]
    assert sum(red["idle_by_phase_s"].values()) == pytest.approx(
        idle, abs=1e-9)
    assert red["idle_s"] == pytest.approx(idle, abs=1e-9)
    by = red["idle_by_phase_s"]
    assert set(by) <= {"hlsh.hash", "hlsh.estimate", "hlsh.route",
                       "hlsh.search.lsh", "hlsh.query", "outside"}
    # hash (2..10): its kernel runs 8..12, so 2..8 of each round is idle
    assert by["hlsh.hash"] == pytest.approx(3 * 6e-6, abs=1e-12)
    # outside hlsh.query (1..89): 0..1, then 95..201 and 295..401 between
    # rounds, and 495..500 at the end
    assert by["outside"] == pytest.approx(218e-6, abs=1e-12)
    assert by["hlsh.query"] == pytest.approx(3 * 3e-6, abs=1e-12)
    r = spans_lib.readings(red, {"query": {"batches": 3, "syncs": 6},
                                 "build_seconds": 1.5})
    assert r["hash_idle_pct"] == pytest.approx(
        100 * by["hlsh.hash"] / red["window_s"])
    assert r["route_wait_ms"] == pytest.approx(9e-3)
    assert r["program_syncs_per_batch"] == 2.0
    assert r["index_build_s"] == 1.5


def test_a_kernel_lands_in_the_span_that_launched_it():
    events = spans_lib.collect(_prof(_events(delta=True)))
    red = spans_lib.reduce(events)
    dev = red["device_s_per_batch"]
    # per batch: launched inside the delta's counts (nested in the
    # estimate), the hash and the search; their device time, not the span's
    assert dev["hlsh.delta.counts"] == pytest.approx(5e-6)
    assert dev["hlsh.estimate"] == pytest.approx(11e-6)
    assert dev["hlsh.hash"] == pytest.approx(4e-6)
    assert dev["hlsh.search.lsh"] == pytest.approx(45e-6)
    assert red["unlinked_kernels"] == 0
    r = spans_lib.readings(red, {})
    assert r["delta_device_ms"] == pytest.approx(5e-3)
    assert r["program_syncs_per_batch"] is None
    assert spans_lib.readings(spans_lib.reduce(spans_lib.collect(
        _prof(_events()))), {})["delta_device_ms"] is None


def test_a_program_without_spans_reads_nothing():
    assert spans_lib.reduce([]) == {}
    assert set(spans_lib.readings({}, {}).values()) == {None}
    bare = [e for e in _events() if not e.name.startswith("hlsh.")]
    red = spans_lib.reduce(spans_lib.collect(_prof(bare)))
    assert red["spans"] == 0
    assert set(spans_lib.readings(red, {}).values()) == {None}


@pytest.mark.parametrize("cell", ["webspam.wide", "covertype.read"])
def test_the_ports_traced_rounds_reduce_on_the_cpu(cell):
    """The port's own spans under a CPU profiler: every phase of a batch
    appears, the idle (no device: the whole window) adds up, the engine
    counts its blocking copies."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bench.lib import harness
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        run = harness.Run(_tiny.ROOT, cell, _tiny.SEED, 0.2, True, "cpu",
                          overrides=_tiny.overrides(cell))
        run.setup()
        run.round()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(3):
                run.round(spans=True)
    finally:
        torch.set_num_threads(saved)
    red = spans_lib.reduce(spans_lib.collect(prof))
    assert red["batches"] == 3
    assert sum(red["idle_by_phase_s"].values()) == pytest.approx(
        red["window_s"], rel=1e-9)
    host = red["host_s_per_batch"]
    assert {"hlsh.query", "hlsh.hash", "hlsh.estimate", "hlsh.route",
            "hlsh.search.lsh"} <= set(host)
    if cell.startswith("covertype"):
        assert {"hlsh.delta.counts", "hlsh.delta.search"} <= set(host)
    stats = run.system.index.index_stats()
    r = spans_lib.readings(red, stats)
    assert r["program_syncs_per_batch"] >= 2
    assert r["index_build_s"] > 0
    assert r["route_wait_ms"] > 0
    assert r["delta_device_ms"] is None       # no device on the CPU
