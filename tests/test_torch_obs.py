"""``repro_torch.obs`` against ``repro.obs``: the same instrument calls
give the same ``snapshot()``, the same Prometheus text, the same spans
and summaries, the same event stream and the same schemas.  The
streaming index's observability surfaces (events, work phases, stats
keys) are checked against the reference's schema too."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.obs as jobs  # noqa: E402
import repro.obs.schema as jschema  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
import repro_torch.obs.schema as tschema  # noqa: E402

PACKAGES = (jobs, tobs)


def _drive_registry(mod):
    reg = mod.MetricsRegistry(enabled=True)
    c = reg.counter("c_total", help="a counter")
    c.inc()
    c.inc(4)
    reg.counter("x_total", labels={"route": "lsh"}).inc(2)
    reg.counter("x_total", labels={"route": "linear", "b": 'q"\\'})
    g = reg.gauge("g", help="a gauge")
    g.set(7.5)
    g.add(-0.25)
    h = reg.histogram("h_seconds", buckets=(1.0, 10.0), help="a histogram",
                      labels={"phase": "search"})
    for v in (0.5, 5.0, 50.0, 1.0):
        h.observe(v)
    reg.histogram("h_seconds", buckets=(1.0, 10.0),
                  labels={"phase": "estimate"}).observe(2.0)
    return reg


def test_registry_snapshot_and_prometheus_text_match():
    a, b = (_drive_registry(m) for m in PACKAGES)
    assert a.snapshot() == b.snapshot()
    assert jobs.to_prometheus(a) == tobs.to_prometheus(b)
    assert "# TYPE h_seconds histogram" in tobs.to_prometheus(b)


def test_null_registry_and_disabled_bundle_match():
    for mod in PACKAGES:
        mod.NULL_REGISTRY.counter("never").inc()
    assert jobs.NULL_REGISTRY.snapshot() == tobs.NULL_REGISTRY.snapshot()
    a, b = jobs.Observability.disabled(), tobs.Observability.disabled()
    assert (a.enabled, a.tracer.enabled, a.events.enabled) == \
        (b.enabled, b.tracer.enabled, b.events.enabled)


def _batch(rng, nq=9):
    coll = rng.integers(0, 500, nq).astype(np.float64)
    est = rng.uniform(0, 300, nq)
    act = rng.integers(0, 300, nq)
    return dict(use_lsh=rng.random(nq) < 0.6, collisions=coll, cand_est=est,
                cand_actual=act, lsh_cost_est=coll + 10 * est,
                lsh_cost_actual=coll + 10 * act.astype(np.float64),
                linear_cost=2500.0, probes=4, forced=None,
                phase_seconds={"estimate": 0.001, "search_lsh": 0.002,
                               "search_linear": 0.003},
                segment_seconds={"search_lsh": [("seg0", 0.001)]},
                kernel_impl="ref")


def test_tracer_spans_summary_and_exposition_match():
    out = []
    for mod in PACKAGES:
        obs = mod.Observability.create(enabled=True, trace_capacity=16,
                                       trace_sample_every=2)
        rng = np.random.default_rng(4)
        obs.tracer.set_context(collection="c1")
        for forced in (None, "lsh", None):
            if obs.tracer.sample():
                obs.tracer.record_batch(**{**_batch(rng), "forced": forced})
        obs.tracer.set_context()
        out.append(obs)
    a, b = out
    assert a.tracer.spans() == b.tracer.spans()
    assert a.tracer.spans(limit=3, strategy="lsh") == \
        b.tracer.spans(limit=3, strategy="lsh")
    assert a.tracer.summary() == b.tracer.summary()
    assert a.tracer.misroute_rate == b.tracer.misroute_rate
    assert a.registry.snapshot() == b.registry.snapshot()
    assert jobs.to_prometheus(a.registry) == tobs.to_prometheus(b.registry)
    assert set(a.tracer.spans()[0]) == set(tobs.SPAN_FIELDS) | {"collection"}
    assert jobs.SPAN_FIELDS == tobs.SPAN_FIELDS


def test_event_log_and_work_phases_match():
    logs = [m.EventLog(capacity=4) for m in PACKAGES]
    for log in logs:
        for i in range(6):
            log.emit("freeze" if i % 2 else "swap", rows=i, reason="x")
    a, b = logs
    strip = [[{k: v for k, v in e.items() if k != "ts"} for e in log.events()]
             for log in logs]
    assert strip[0] == strip[1]
    assert a.counts_by_kind() == b.counts_by_kind()
    assert (len(a), a.seq, a.dropped) == (len(b), b.seq, b.dropped)
    ph = [m.WorkPhases("stage", "build") for m in PACKAGES]
    for p in ph:
        p.add("stage", 0.25)
        p.add("build", 0.5)
        p.add("stage", 0.125)
    assert ph[0].as_dict() == ph[1].as_dict() and ph[1].total == 0.875
    for mod, p in zip(PACKAGES, ph):
        with mod.time_block(phases=p, phase="build") as tb:
            pass
        assert tb.elapsed >= 0.0


def test_schemas_are_the_references():
    for name in jschema.__all__:
        assert getattr(jschema, name) is not None
        if name == "retrieval_stats_keys":
            for kw in ({}, {"sharded": True}):
                assert jschema.retrieval_stats_keys(**kw) == \
                    tschema.retrieval_stats_keys(**kw)
        else:
            assert getattr(jschema, name) == getattr(tschema, name), name


def test_streaming_index_reports_the_reference_schema():
    """The port's index stats, driver stats and events carry the keys
    the reference's schema pins."""
    from repro_torch.core.lsh import make_family
    from repro_torch.streaming import (CompactionDriver, CompactionPolicy,
                                       DynamicHybridIndex)
    obs = tobs.Observability.create(enabled=True)
    idx = DynamicHybridIndex(make_family("l2", d=8, L=3, r=1.0),
                             num_buckets=64, m=16, delta_capacity=32,
                             policy=CompactionPolicy(fanout=2, step_rows=16),
                             obs=obs, device="cpu")
    x = np.random.default_rng(0).normal(size=(200, 8)).astype(np.float32)
    idx.build(x[:64])
    idx.insert(x[64:])
    idx.delete(range(0, 200, 5))
    drv = CompactionDriver(idx)
    drv.flush()
    assert set(idx.index_stats()) == tschema.INDEX_STATS_KEYS
    assert set(drv.stats()) == tschema.DRIVER_STATS_KEYS
    assert set(idx.compaction_work_seconds) == tschema.WORK_PHASE_KEYS
    kinds = obs.events.counts_by_kind()
    assert kinds["freeze"] >= 2 and kinds["swap"] >= 1
    for e in obs.events.events():
        assert tschema.EVENT_BASE_FIELDS <= set(e)
