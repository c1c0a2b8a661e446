"""The model-free serving layer of ``repro_torch.serve`` on the CPU:
``ResultCache``, ``ShapeBucketScheduler`` / ``TenantQuota`` /
``route_and_group`` and ``CollectionManager``.

  * the scheduler and cache tests of ``tests/test_serve.py`` and the
    scheduler and manager tests of ``tests/test_collections.py`` that
    need no ``RetrievalService``, ported (stats schemas matched exactly
    against ``repro_torch.obs.schema``, whose sets equal the
    reference's);
  * differential runs against ``repro.serve``: one random op stream of
    submits / quotas / drains / drops under an injected clock through
    both packages' schedulers (equal batches, padded sizes and stats),
    and of puts / gets / purges / drops through both caches;
  * ``route_and_group`` equal to ``repro``'s power-of-two padded groups
    on random masks and several ``min_bucket``;
  * a collection tree checkpointed through ``CheckpointManager``
    (``collection_names`` reads the manifest), restored into a fresh
    manager with equal sets on every route, and loaded by the
    reference's manager too.
"""
import math
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.obs.schema as jschema  # noqa: E402
import repro_torch.obs.schema as tschema  # noqa: E402
from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.core import CostModel as JCostModel  # noqa: E402
from repro.core.lsh import make_family as jmake_family  # noqa: E402
from repro.serve import ResultCache as JCache  # noqa: E402
from repro.serve import ShapeBucketScheduler as JScheduler  # noqa: E402
from repro.serve.collections import CollectionManager as JCollections  # noqa: E402
from repro.serve.scheduler import route_and_group as jroute_and_group  # noqa: E402
from repro.streaming import CompactionPolicy as JPolicy  # noqa: E402
from repro.streaming import DynamicHybridIndex as JDyn  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core import CostModel, QueryEngine  # noqa: E402
from repro_torch.core.lsh import make_family  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.obs import MetricsRegistry, Observability  # noqa: E402
from repro_torch.obs.schema import (CACHE_STATS_KEYS,  # noqa: E402
                                    COLLECTION_MANAGER_KEYS,
                                    COLLECTION_STATS_KEYS,
                                    DRIVER_STATS_KEYS, SCHEDULER_STATS_KEYS,
                                    SCHEDULER_TENANT_KEYS)
from repro_torch.serve import (CollectionManager, ResultCache,  # noqa: E402
                               ShapeBucketScheduler, TenantQuota,
                               route_and_group)
from repro_torch.streaming import (CompactionDriver,  # noqa: E402
                                   CompactionPolicy, DynamicHybridIndex)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_schemas_equal_the_reference():
    for name in ("CACHE_STATS_KEYS", "SCHEDULER_STATS_KEYS",
                 "SCHEDULER_TENANT_KEYS", "COLLECTION_MANAGER_KEYS",
                 "COLLECTION_STATS_KEYS", "CHECKPOINT_STATS_KEYS"):
        assert getattr(tschema, name) == getattr(jschema, name), name


# --------------------------------------------------------------------------
# scheduler + cache (tests/test_serve.py)
# --------------------------------------------------------------------------
def test_scheduler_pow2_bucketing():
    sched = ShapeBucketScheduler(max_batch=16, min_bucket=4)
    for i in range(21):
        sched.submit(i)
    reqs, padded = sched.next_batch()
    assert len(reqs) == 16 and padded == 16
    reqs, padded = sched.next_batch()
    assert len(reqs) == 5 and padded == 8
    reqs, padded = sched.next_batch()
    assert len(reqs) == 0 and padded == 0


def test_scheduler_empty_drain_and_tick_monotone():
    """Draining an empty queue is a well-formed no-op batch, and ticks
    increase by exactly one per next_batch when a background_tick is
    registered — never without one."""
    calls = []
    sched = ShapeBucketScheduler(max_batch=8, min_bucket=4,
                                 background_tick=lambda: calls.append(1))
    assert sched.ticks == 0
    seen = []
    for _ in range(3):
        reqs, padded = sched.next_batch()
        assert reqs == [] and padded == 0
        seen.append(sched.ticks)
    assert seen == [1, 2, 3] and len(calls) == 3
    plain = ShapeBucketScheduler(max_batch=8)
    plain.submit("x")
    plain.next_batch()
    assert plain.ticks == 0


def test_scheduler_all_linear_route_and_group():
    use_lsh = np.zeros(10, bool)
    lsh_idx, lin_idx = route_and_group(use_lsh, min_bucket=4)
    assert len(lsh_idx) == 0            # empty group stays empty, no pad
    assert set(lin_idx.tolist()) == set(range(10))
    assert len(lin_idx) == 16
    lsh_idx2, lin_idx2 = route_and_group(torch.from_numpy(~use_lsh),
                                         min_bucket=4)
    assert len(lin_idx2) == 0
    assert set(lsh_idx2.tolist()) == set(range(10))


@pytest.mark.parametrize("min_bucket", [1, 4, 8, 32])
def test_route_and_group_matches_reference(min_bucket):
    """Equal to ``repro``'s padded groups (values and dtype) on random
    masks of every density, empty and full included."""
    rng = np.random.default_rng(min_bucket)
    for q in (0, 1, 2, 5, 8, 9, 31, 64, 100):
        for p in (0.0, 0.1, 0.5, 0.9, 1.0):
            mask = rng.random(q) < p
            got = route_and_group(mask, min_bucket=min_bucket)
            want = jroute_and_group(mask, min_bucket=min_bucket)
            for g, w in zip(got, want):
                assert g.dtype == np.asarray(w).dtype
                np.testing.assert_array_equal(g, np.asarray(w))


def test_scheduler_registry_instruments():
    reg = MetricsRegistry(enabled=True)
    sched = ShapeBucketScheduler(max_batch=8, min_bucket=4, registry=reg,
                                 background_tick=lambda: None)
    for i in range(5):
        sched.submit(i)
    sched.next_batch()
    snap = reg.snapshot()
    assert snap["counters"]["repro_scheduler_submits_total"] == 5
    assert snap["counters"]["repro_scheduler_batches_total"] == 1
    assert snap["counters"]["repro_scheduler_ticks_total"] == 1
    assert snap["histograms"]["repro_scheduler_batch_size"]["count"] == 1


def test_scheduler_deadline_coalescing():
    now = [0.0]
    sched = ShapeBucketScheduler(max_batch=8, min_bucket=4,
                                 max_wait_s=1.0, clock=lambda: now[0])
    for i in range(3):
        sched.submit(i)
    assert sched.next_batch() == ([], 0)      # deadline not reached
    now[0] = 0.5
    assert sched.next_batch() == ([], 0)
    now[0] = 1.25
    reqs, padded = sched.next_batch()
    assert len(reqs) == 3 and padded == 4
    assert all(abs(r.wait_s - 1.25) < 1e-9 for r in reqs)
    for i in range(8):
        sched.submit(i)
    reqs, padded = sched.next_batch()
    assert len(reqs) == 8 and padded == 8
    st = sched.stats()
    assert st["batches"] == 2 and st["requests_batched"] == 11
    assert abs(st["queue_wait_max_s"] - 1.25) < 1e-9


def test_scheduler_force_flush_inside_deadline():
    now = [0.0]
    sched = ShapeBucketScheduler(max_batch=8, min_bucket=4,
                                 max_wait_s=60.0, clock=lambda: now[0])
    sched.submit("a")
    assert sched.next_batch() == ([], 0)
    reqs, padded = sched.next_batch(force=True)
    assert len(reqs) == 1 and padded == 4
    assert sched.next_batch(force=True) == ([], 0)


def test_scheduler_admission_control():
    reg = MetricsRegistry(enabled=True)
    sched = ShapeBucketScheduler(max_batch=8, max_queue=4, registry=reg)
    uids = [sched.submit(i) for i in range(6)]
    assert all(u is not None for u in uids[:4])
    assert uids[4] is None and uids[5] is None
    assert len(sched.queue) == 4
    st = sched.stats()
    assert st["submits"] == 4 and st["rejects"] == 2
    snap = reg.snapshot()
    assert snap["counters"]["repro_scheduler_rejects_total"] == 2
    assert snap["counters"]["repro_scheduler_submits_total"] == 4
    sched.next_batch()
    assert sched.submit("again") is not None


def test_scheduler_empty_drain_counts_no_phantom_batch():
    reg = MetricsRegistry(enabled=True)
    sched = ShapeBucketScheduler(max_batch=8, min_bucket=4, registry=reg,
                                 background_tick=lambda: None)
    for _ in range(3):
        sched.next_batch()
    snap = reg.snapshot()
    assert snap["counters"]["repro_scheduler_ticks_total"] == 3
    assert snap["counters"].get("repro_scheduler_batches_total", 0) == 0
    assert snap["histograms"]["repro_scheduler_batch_size"]["count"] == 0
    sched.submit("x")
    sched.next_batch()
    snap = reg.snapshot()
    assert snap["counters"]["repro_scheduler_batches_total"] == 1
    assert snap["histograms"]["repro_scheduler_batch_size"]["count"] == 1
    assert snap["histograms"]["repro_scheduler_queue_wait_seconds"][
        "count"] == 1


def test_scheduler_stats_schema():
    assert set(ShapeBucketScheduler(max_batch=8).stats()) == \
        SCHEDULER_STATS_KEYS


def test_result_cache_lru_and_version_purge():
    def entry(seed, k=64):
        rng = np.random.default_rng(seed)
        return ([rng.integers(0, 100, k)], [rng.random(k, np.float32)])

    cache = ResultCache(max_bytes=4096)
    assert set(cache.stats()) == CACHE_STATS_KEYS
    tok = np.arange(8, dtype=np.int32)[None, :]
    keys = [cache.key(1, 0.5, tok + i) for i in range(6)]
    for i, k in enumerate(keys):
        cache.put(k, *entry(i))
    assert cache._bytes <= 4096
    assert len(cache) < 6
    assert cache.stats()["evictions"] > 0
    assert cache.get(keys[-1]) is not None
    assert cache.get(keys[0]) is None
    cache.put(cache.key(2, 0.5, tok), *entry(9))
    n_v1 = sum(1 for k in cache._entries if k[1] == 1)
    assert cache.purge_stale(2) == n_v1 and n_v1 >= 1
    assert all(k[1] == 2 for k in cache._entries)
    assert cache.purge_stale(2) == 0
    assert cache.stats()["stale_drops"] == n_v1
    assert cache.key(1, 0.5, tok) != cache.key(1, 0.6, tok)
    assert cache.key(1, 0.5, tok) != cache.key(1, 0.5, tok.astype(np.int64))
    ka = cache.key(2, 0.5, tok, collection="a")
    assert ka != cache.key(2, 0.5, tok)
    cache.put(ka, *entry(10))
    assert cache.purge_stale(2, collection="a") == 0
    assert cache.get(ka) is not None
    assert cache.drop_collection("a") == 1
    assert cache.get(ka) is None
    off = ResultCache(max_bytes=0)
    assert not off.put(off.key(1, 0.5, tok), *entry(0))
    assert off.get(off.key(1, 0.5, tok)) is None


# --------------------------------------------------------------------------
# differential runs against repro.serve
# --------------------------------------------------------------------------
def _scheduler_ops(seed, n=300):
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(0, 10)), int(rng.integers(0, 1 << 30)))
            for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduler_matches_reference_on_an_op_stream(seed):
    """Submits over four tenants, quota changes, clock steps, forced
    and deadline drains, drops: both schedulers return the same batches
    (uids, payloads, tenants, waits), padded sizes and stats."""
    names = ("", "a", "b", "c")
    clocks = (FakeClock(), FakeClock())
    kw = dict(max_batch=8, min_bucket=2, max_wait_s=0.5, max_queue=24)
    port = ShapeBucketScheduler(clock=clocks[0], **kw)
    ref = JScheduler(clock=clocks[1], **kw)
    for kind, arg in _scheduler_ops(seed):
        name = names[arg % 4]
        if kind <= 4:
            outs = [s.submit({"v": arg}, collection=name) for s in (port, ref)]
            assert outs[0] == outs[1]
        elif kind == 5:
            q = dict(rate=float(1 + arg % 5), burst=float(1 + arg % 3),
                     weight=float(1 + arg % 4))
            for s in (port, ref):
                s.set_quota(name, **q)
        elif kind == 6:
            for c in clocks:
                c.t += (arg % 100) / 100.0
        elif kind in (7, 8):
            outs = [s.next_batch(force=kind == 8) for s in (port, ref)]
            (ta, pa), (tb, pb) = outs
            assert pa == pb
            assert [(r.uid, r.payload, r.collection, r.wait_s) for r in ta] \
                == [(r.uid, r.payload, r.collection, r.wait_s) for r in tb]
        else:
            assert port.drop_collection(name) == ref.drop_collection(name)
        assert port.stats() == ref.stats()


@pytest.mark.parametrize("seed", [0, 1])
def test_result_cache_matches_reference_on_an_op_stream(seed):
    """Puts, gets, stale purges and collection drops over a small byte
    budget: equal hits, misses, returned entries and stats."""
    rng = np.random.default_rng(seed)
    port, ref = ResultCache(max_bytes=6000), JCache(max_bytes=6000)
    tok = np.arange(6, dtype=np.int32)[None, :]
    for _ in range(400):
        kind, v, col, t = (int(rng.integers(0, 5)), int(rng.integers(0, 3)),
                           "abc"[int(rng.integers(0, 3))],
                           int(rng.integers(0, 12)))
        keys = [c.key(v, 0.5, tok + t, collection=col) for c in (port, ref)]
        assert keys[0] == keys[1]
        if kind <= 1:
            k = int(rng.integers(1, 200))
            ids = np.arange(k, dtype=np.int64)
            dists = np.linspace(0, 1, k, dtype=np.float32)
            assert (port.put(keys[0], [ids], [dists])
                    == ref.put(keys[1], [ids.copy()], [dists.copy()]))
        elif kind == 2:
            a, b = port.get(keys[0]), ref.get(keys[1])
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a[0][0], b[0][0])
        elif kind == 3:
            assert port.purge_stale(v, col) == ref.purge_stale(v, col)
        else:
            assert port.drop_collection(col) == ref.drop_collection(col)
        assert port.stats() == ref.stats()


# --------------------------------------------------------------------------
# scheduler quotas + weighted-fair drain (tests/test_collections.py)
# --------------------------------------------------------------------------
def test_tenant_quota_rejects_at_own_bucket():
    clock = FakeClock()
    reg = MetricsRegistry(enabled=True)
    sched = ShapeBucketScheduler(max_batch=8, registry=reg, clock=clock)
    sched.set_quota("noisy", rate=2.0, burst=3.0)
    admitted = sum(sched.submit({"i": i}, collection="noisy") is not None
                   for i in range(10))
    assert admitted == 3
    assert sched.submit({"i": 0}, collection="quiet") is not None
    ts = sched.stats()["tenants"]
    assert ts["noisy"]["rejects"] == 7 and ts["noisy"]["submits"] == 3
    assert ts["quiet"]["rejects"] == 0 and ts["quiet"]["submits"] == 1
    snap = reg.snapshot()["counters"]
    assert snap['repro_scheduler_rejects_total'
                '{collection="noisy",reason="quota"}'] == 7
    clock.t += 1.0
    assert sched.submit({"i": 0}, collection="noisy") is not None
    assert sched.submit({"i": 1}, collection="noisy") is not None
    assert sched.submit({"i": 2}, collection="noisy") is None


def test_global_queue_bound_labeled_per_tenant():
    reg = MetricsRegistry(enabled=True)
    sched = ShapeBucketScheduler(max_batch=4, max_queue=2, registry=reg,
                                 clock=FakeClock())
    assert sched.submit({}, collection="a") is not None
    assert sched.submit({}, collection="b") is not None
    assert sched.submit({}, collection="a") is None
    snap = reg.snapshot()["counters"]
    assert snap['repro_scheduler_rejects_total'
                '{collection="a",reason="queue_full"}'] == 1
    assert snap["repro_scheduler_rejects_total"] == 1


def test_weighted_fair_drain_shares_and_order():
    sched = ShapeBucketScheduler(max_batch=8, clock=FakeClock())
    sched.set_quota("big", weight=3.0)
    sched.set_quota("small", weight=1.0)
    for i in range(12):
        sched.submit({"i": i}, collection="big")
        sched.submit({"i": i}, collection="small")
    take, padded = sched.next_batch()
    assert padded == 8 and len(take) == 8
    by_col = {}
    for r in take:
        by_col.setdefault(r.collection, []).append(r)
    assert len(by_col["big"]) == 6 and len(by_col["small"]) == 2
    assert [r.uid for r in take] == sorted(r.uid for r in take)
    assert [r.payload["i"] for r in by_col["big"]] == [0, 1, 2, 3, 4, 5]
    assert [r.payload["i"] for r in by_col["small"]] == [0, 1]


def test_weighted_drain_never_starves_quiet_tenant():
    clock = FakeClock()
    sched = ShapeBucketScheduler(max_batch=8, clock=clock)
    sched.set_quota("noisy", weight=1.0)
    sched.set_quota("quiet", weight=1.0)
    for i in range(100):
        sched.submit({"i": i}, collection="noisy")
    clock.t = 5.0
    quiet_uid = sched.submit({"i": -1}, collection="quiet")
    clock.t = 6.0
    take, _ = sched.next_batch()
    assert quiet_uid in {r.uid for r in take}
    ts = sched.stats()["tenants"]
    assert ts["quiet"]["queue_wait_max_s"] == 1.0
    assert ts["noisy"]["queue_wait_max_s"] == 6.0


def test_drop_collection_discards_queue_and_state():
    sched = ShapeBucketScheduler(max_batch=4, clock=FakeClock())
    for _ in range(3):
        sched.submit({}, collection="x")
    sched.submit({}, collection="y")
    assert sched.drop_collection("x") == 3
    assert sched.stats()["queue_depth"] == 1
    assert "x" not in sched.stats()["tenants"]
    take, _ = sched.next_batch()
    assert [r.collection for r in take] == ["y"]


def test_scheduler_tenant_stats_schema_pinned():
    sched = ShapeBucketScheduler(max_batch=4, clock=FakeClock())
    sched.set_quota("t", rate=5.0, weight=2.0)
    sched.submit({}, collection="t")
    s = sched.stats()
    assert set(s) == SCHEDULER_STATS_KEYS
    assert set(s["tenants"]) == {"t"}
    assert set(s["tenants"]["t"]) == SCHEDULER_TENANT_KEYS
    assert s["tenants"]["t"]["burst"] == 5.0
    assert s["tenants"]["t"]["weight"] == 2.0
    assert math.isinf(TenantQuota().rate)


# --------------------------------------------------------------------------
# collection manager over bare port indexes
# --------------------------------------------------------------------------
D = 8
R = 0.6


def _family():
    return make_family("l2", d=D, L=4, r=1.0)


def _policy(step_rows=None):
    return dict(delta_fill=1.0, tombstone_ratio=2.0, fanout=2,
                step_rows=step_rows)


def _bare_factory(delta_capacity=16, step_rows=None, params=None):
    """Port indexes around one family, one set of params and one
    ``QueryEngine``, as a serving layer would share them."""
    fam = _family()
    engine = QueryEngine(CostModel(alpha=1.0, beta=1.0))

    def factory(obs):
        return DynamicHybridIndex(
            fam, num_buckets=64, m=32, cap=32, delta_capacity=delta_capacity,
            cost_model=CostModel(alpha=1.0, beta=1.0),
            policy=CompactionPolicy(**_policy(step_rows)), params=params,
            seed=0, obs=obs, engine=engine, device="cpu")
    return factory


def _rows(rng, n):
    return rng.normal(size=(n, D)).astype(np.float32)


def test_manager_lifecycle_names_and_events():
    obs = Observability.create(enabled=True)
    mgr = CollectionManager(_bare_factory(), obs=obs)
    for bad in ("", "a/b", ".hidden", "sp ace", "-lead"):
        with pytest.raises(ValueError):
            mgr.create(bad)
    col = mgr.create("t1", quota=TenantQuota(rate=9.0, burst=9.0))
    with pytest.raises(ValueError):
        mgr.create("t1")
    assert "t1" in mgr and len(mgr) == 1 and mgr.names() == ["t1"]
    with pytest.raises(KeyError):
        mgr.get("missing")
    rng = np.random.default_rng(0)
    col.index.build(_rows(rng, 8))
    col.index.insert(_rows(rng, 16))
    col.index.insert(_rows(rng, 16))
    kinds = {}
    for ev in obs.events.events():
        if ev.get("collection") == "t1":
            kinds[ev["kind"]] = kinds.get(ev["kind"], 0) + 1
    assert "collection_create" in kinds
    assert len(kinds) > 1                     # index events labeled too
    dropped = mgr.drop("t1")
    assert dropped is col and len(mgr) == 0
    assert any(ev["kind"] == "collection_drop" for ev in obs.events.events())
    mgr.create("t1")


def test_manager_stats_schema_pinned():
    mgr = CollectionManager(_bare_factory())
    mgr.create("u")
    mgr.create("v", quota=TenantQuota(rate=4.0, burst=2.0, weight=3.0))
    mgr.get("u").index.build(_rows(np.random.default_rng(1), 12))
    mgr.note_query("u", n_queries=5, n_linear=2)
    s = mgr.stats()
    assert set(s) == COLLECTION_MANAGER_KEYS
    assert s["n_collections"] == 2
    assert set(s["collections"]) == {"u", "v"}
    for sub in s["collections"].values():
        assert set(sub) == COLLECTION_STATS_KEYS
    assert s["collections"]["u"]["n_live"] == 12
    assert s["collections"]["u"]["queries"] == 5
    assert s["collections"]["u"]["linear_served"] == 2
    assert s["collections"]["v"]["quota_weight"] == 3.0
    mgr.drop("u")
    assert mgr.stats()["dropped_total"] == 1


def test_manager_drop_purges_cache_and_scheduler():
    """Dropping a collection removes its queued requests and cache
    entries; a re-created namesake starts at version 0 and never sees
    the old tenant's cached results."""
    cache = ResultCache(max_bytes=1 << 16)
    sched = ShapeBucketScheduler(max_batch=4, clock=FakeClock())
    mgr = CollectionManager(_bare_factory(), scheduler=sched, cache=cache)
    mgr.create("t")
    sched.submit({}, collection="t")
    tok = np.arange(6, dtype=np.int32)[None, :]
    k = cache.key(0, 0.5, tok, collection="t")
    cache.put(k, [np.arange(3)], [np.zeros(3, np.float32)])
    assert cache.get(k) is not None
    mgr.drop("t")
    assert cache.get(k) is None
    assert sched.stats()["queue_depth"] == 0
    assert mgr.create("t").index.version == 0
    assert cache.get(cache.key(0, 0.5, tok, collection="t")) is None


def test_driver_round_robin_fairness_two_collections():
    """One driver worker serves staged merge work for both attached
    collections: neither monopolizes it, and both stacks drain."""
    obs = Observability.create(enabled=True)
    driver = CompactionDriver(budget_rows=8, obs=obs, poll_s=0.005)
    mgr = CollectionManager(_bare_factory(delta_capacity=16, step_rows=8),
                            obs=obs, driver=driver)
    rng = np.random.default_rng(2)
    a = mgr.create("a", attach=False)
    b = mgr.create("b", attach=False)
    for col in (a, b):
        col.index.build(_rows(rng, 8))
    mgr.attach_driver("a")
    mgr.attach_driver("b")
    driver.start()
    try:
        for _ in range(3):
            a.index.insert(_rows(rng, 16))
            b.index.insert(_rows(rng, 16))
            driver.notify()
        deadline = time.monotonic() + 20.0
        while ((a.index.has_compaction_work or b.index.has_compaction_work)
               and time.monotonic() < deadline):
            driver.drain()
            time.sleep(0.01)
    finally:
        driver.stop(flush=True)
    st = driver.stats()
    assert set(st) == DRIVER_STATS_KEYS
    assert st["collections"] == 2 and st["worker_errors"] == 0
    assert st["fairness"].get("a", 0) > 0
    assert st["fairness"].get("b", 0) > 0
    assert not a.index.has_compaction_work
    assert not b.index.has_compaction_work


def test_collection_tree_checkpoint_round_trip(tmp_path):
    """``{"collections": mgr.state_dict()}`` saved incrementally (with
    the manager's digest hints under ``collections/``):
    ``collection_names`` lists the tenants from the manifest alone; a
    fresh manager restores every tenant with its quota and equal sets
    on every route; the reference's manager loads the same step into
    its own indexes with equal sets too."""
    jfam = jmake_family("l2", d=D, L=4, r=1.0)
    jparams = JDyn(jfam, num_buckets=64, m=32, key=0).params
    params = params_from_numpy({k: np.asarray(v)
                                for k, v in jparams.items()}, "cpu")
    sched = ShapeBucketScheduler(max_batch=8, clock=FakeClock())
    mgr = CollectionManager(_bare_factory(params=params), scheduler=sched)
    rng = np.random.default_rng(5)
    for i, name in enumerate(("a", "b", "c")):
        col = mgr.create(name, quota=TenantQuota(rate=10.0 * (i + 1),
                                                 burst=5.0, weight=1.0 + i))
        col.index.build(_rows(rng, 40 + 10 * i))
        col.index.insert(_rows(rng, 30))          # crosses the delta: freezes
        col.index.delete([1, 3, 41])
    ck = CheckpointManager(str(tmp_path))
    ck.save_incremental(1, {"collections": mgr.state_dict()},
                        digests={f"collections/{k}": v
                                 for k, v in mgr.state_digests().items()},
                        blocking=True)
    assert ck.collection_names(1) == ["a", "b", "c"]
    assert ck.collection_names() == ["a", "b", "c"]
    q = _rows(np.random.default_rng(6), 10)

    fresh = CollectionManager(_bare_factory(params=params),
                              scheduler=ShapeBucketScheduler(max_batch=8))
    tree, step = ck.restore_tree()
    fresh.load_state_dict(tree["collections"])
    assert fresh.names() == ["a", "b", "c"]
    assert fresh.stats()["collections"]["c"]["quota_weight"] == 3.0
    assert fresh.scheduler.stats()["tenants"]["b"]["rate"] == 20.0

    def jfactory(obs):
        return JDyn(jfam, num_buckets=64, m=32, cap=32, delta_capacity=16,
                    cost_model=JCostModel(alpha=1.0, beta=1.0),
                    policy=JPolicy(**_policy()), key=0, obs=obs)

    jmgr = JCollections(jfactory)
    jtree, _ = JManager(str(tmp_path)).restore_tree()
    jmgr.load_state_dict(jtree["collections"])
    for name in ("a", "b", "c"):
        old, new = mgr.get(name).index, fresh.get(name).index
        assert new.state_digests() == old.state_digests()
        assert jmgr.get(name).index.state_digests() == old.state_digests()
        for force in (None, "lsh", "linear"):
            want = old.query(q, R, force=force).neighbor_sets()
            assert new.query(q, R, force=force).neighbor_sets() == want
            if force is not None:
                got = jmgr.get(name).index.query(q, R, force=force)
                assert got.neighbor_sets() == want, (name, force)
