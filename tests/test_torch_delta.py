"""The streaming delta over the rows it holds, on the CPU (plain path).

The delta's collision counts (``collision_stats``), its LSH route
(``search``) and its linear route (its ``scan_part`` in the engine's
``search_group``) read only the ``count`` rows written, the only slots
that can be live.  Each is held to the full-capacity chain the port
ran before (``torch_cases.delta_full_chain``: every slot of C + 1, trash
row included): counts equal, the same (id, distance) pairs reported.  A
freshly built ``DynamicHybridIndex`` (an empty delta) reports no delta
columns and the same sets as with the full-capacity delta, and counts
the batch in ``index_stats()["delta_empty_batches"]``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import CostModel, QueryEngine
from repro_torch.core.engine import TableSegment
from repro_torch.core.lsh import make_family
from repro_torch.kernels import ops
from repro_torch.kernels.ref import EXT_SENTINEL, scan_epilogue
from repro_torch.streaming import DynamicHybridIndex
from repro_torch.streaming import delta as delta_lib
from torch_cases import (DELTA_COUNTS, DELTA_PROBES, delta_case,
                         delta_full_chain)

CPU = torch.device("cpu")
METRICS = ("l2", "l1", "cosine", "hamming")
DELTA_RADII = {"l2": 2.5, "l1": 4.0, "cosine": 0.6, "hamming": 30.0}
INDEX_RADII = {"l2": 2.0, "l1": 5.0, "cosine": 0.15}


def _full_capacity_search(delta, qb, q, r, metric, lsh_route, tidx):
    """The delta's scan over all C + 1 slots, as reported."""
    _, dists, mask = ops.fused_linear_scan(q, delta.x, r, metric)
    mask = mask & delta.live[None, :]
    if lsh_route:
        mask = mask & delta_full_chain(delta, qb, tidx, "mask")
    return scan_epilogue(delta.ids[None, :].expand(dists.shape), dists, mask,
                         None, delta.ids)


def _pairs(ids, dists, mask):
    """Per query, the reported {id: distance}."""
    return [dict(zip(ids[i][mask[i]].tolist(), dists[i][mask[i]].tolist()))
            for i in range(ids.shape[0])]


def _assert_same_pairs(got, want, metric, r):
    """The same ids reported for each query, at the same distances up to
    float32 rounding (a product over another number of rows may round a
    last bit), an id within 1e-5 of the threshold t excepted."""
    t = ops.metric_radius_transform(metric, r)
    for g, w in zip(_pairs(*got), _pairs(*want)):
        for i in set(g) ^ set(w):
            assert abs(g.get(i, w.get(i)) - t) <= 1e-5 * max(1.0, t), i
        for i in set(g) & set(w):
            assert g[i] == pytest.approx(w[i], rel=1e-6, abs=1e-6), i


@pytest.mark.parametrize("probes", DELTA_PROBES)
@pytest.mark.parametrize("count", DELTA_COUNTS)
def test_collision_stats_over_count_rows_match_full_capacity(count, probes):
    delta, _, qb, tidx = delta_case(count, probes, CPU, seed=count)
    coll, dist = delta_lib.collision_stats(delta, qb, tidx=tidx)
    want_coll, want_dist = delta_full_chain(delta, qb, tidx, "counts")
    assert coll.dtype == dist.dtype == torch.int32
    assert torch.equal(coll, want_coll) and torch.equal(dist, want_dist)
    if count > 1:       # the case collides, and some collision is dead
        assert bool((want_coll > 0).any())
        assert not bool(delta.live[:count].all())
    mask = ops.delta_collide(qb, delta.bucket_ids[:count],
                             delta.live[:count], tidx, "mask")
    assert mask.shape == (qb.shape[0], count)
    assert torch.equal(mask, delta_full_chain(delta, qb, tidx,
                                              "mask")[:, :count])
    assert torch.equal(dist, mask.sum(1, dtype=torch.int32))


@pytest.mark.parametrize("lsh_route", [True, False])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("count", DELTA_COUNTS)
def test_search_over_count_rows_reports_full_capacity_pairs(count, metric,
                                                            lsh_route):
    probes = 3 if metric == "cosine" else 1
    delta, q, qb, tidx = delta_case(count, probes, CPU, seed=count,
                                    metric=metric, buckets=3)
    r = DELTA_RADII[metric]
    view = delta_lib.DeltaView(delta, metric, tidx=tidx)
    got = QueryEngine(CostModel()).search_group([view], qb, q, r,
                                                lsh_route=lsh_route)
    assert all(t.shape == (q.shape[0], count) for t in got)
    want = _full_capacity_search(delta, qb, q, r, metric, lsh_route, tidx)
    assert want[0].shape[1] == delta.capacity + 1
    _assert_same_pairs(got, want, metric, r)
    assert bool((got[0][~got[2]] == EXT_SENTINEL).all())
    if count >= 32:
        assert bool(got[2].any())
    assert view.scan_part().x.shape[0] == count


def _full_capacity_delta(mp):
    """Patch the delta back to the full-capacity chain (every slot)."""
    def full_search(delta, qbuckets, q, r, metric, impl=None, tidx=None):
        out = _full_capacity_search(delta, qbuckets, q, r, metric, True,
                                    tidx)
        return delta.ids[None, :].expand(out[1].shape), out[1], out[2]
    mp.setattr(delta_lib, "collision_stats",
               lambda delta, qbuckets, tidx=None, impl=None:
               delta_full_chain(delta, qbuckets, tidx, "counts"))
    mp.setattr(delta_lib, "search", full_search)
    mp.setattr(delta_lib.DeltaView, "scan_part", lambda self: ops.ScanPart(
        self.delta.x, self.delta.live, self.delta.ids))


def _fresh_index(metric):
    rng = np.random.default_rng(5)
    if metric == "hamming":
        x = rng.integers(0, 2**32, (600, 2), dtype=np.uint32)
        fam, r = make_family("hamming", d=64, L=6, r=16.0), 24.0
    else:
        x = rng.normal(size=(600, 8)).astype(np.float32)
        r = INDEX_RADII[metric]
        fam = make_family(metric, d=8, L=6, r=r)
    idx = DynamicHybridIndex(fam, num_buckets=64, m=32, cap=64,
                             delta_capacity=96, seed=0,
                             device="cpu").build(x)
    return idx, x[::30], r


@pytest.mark.parametrize("metric", METRICS)
def test_fresh_index_reports_no_delta_columns(metric, monkeypatch):
    """An empty delta adds no columns to either route's buffers, and the
    sets equal those of the full-capacity delta."""
    idx, q, r = _fresh_index(metric)
    assert idx.delta.count == 0 and len(idx.stack.segments) == 1
    frozen = [s for s in idx._segments() if isinstance(s, TableSegment)]
    rows = idx._rows(q)
    qb = idx._bucket_fn(idx.params, rows)
    got = {f: idx.query(q, r, force=f) for f in (None, "lsh", "linear")}
    for f, lsh in (("lsh", True), ("linear", False)):
        width = idx._engine.search_group(frozen, qb, rows, r,
                                         lsh_route=lsh)[0].shape[1]
        out = got[f].lsh_out if lsh else got[f].lin_out
        assert out[0].shape == (len(q), width), f
    st = idx.index_stats()
    assert st["delta_empty_batches"] == 3 and st["delta_kernel_batches"] == 0

    _full_capacity_delta(monkeypatch)
    for f, res in got.items():
        before = idx.query(q, r, force=f)
        assert np.array_equal(before.route.collisions.numpy(),
                              res.route.collisions.numpy()), f
        assert before.neighbor_sets() == res.neighbor_sets(), f
        for a, b in ((before.lsh_out, res.lsh_out),
                     (before.lin_out, res.lin_out)):
            if a is not None:
                assert a[0].shape[1] == b[0].shape[1] + idx.delta.capacity + 1


def test_churned_index_counts_its_delta_batches():
    """Once the delta holds rows, batches stop counting as empty; on the
    CPU no batch launches the kernel."""
    idx, q, r = _fresh_index("l1")
    rng = np.random.default_rng(6)
    idx.query(q, r)
    idx.insert(rng.normal(size=(40, 8)).astype(np.float32))
    idx.delete([600, 601, 3])
    assert idx.delta.count == 40
    for f in (None, "lsh", "linear"):
        idx.query(q, r, force=f)
    st = idx.index_stats()
    assert (st["delta_empty_batches"], st["delta_kernel_batches"]) == (1, 0)


def test_sharded_index_counts_its_deltas_and_keeps_its_width(monkeypatch):
    """A 2-shard index on the CPU, its deltas empty, one empty, none: each
    shard's (Q, max_out) buffer keeps the full-capacity delta's width
    (the columns a delta no longer adds padded with masked slots) and
    the same sets; batches count in ``delta_empty_batches`` while some
    shard's delta is empty."""
    from repro_torch.core.distributed import make_mesh
    from repro_torch.streaming import (CompactionPolicy,
                                       ShardedDynamicHybridIndex)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(400, 8)).astype(np.float32)
    sh = ShardedDynamicHybridIndex(
        make_family("l2", d=8, L=4, r=2.0), num_buckets=64,
        mesh=make_mesh(2, device="cpu"), m=32, cap=64, delta_capacity=64,
        policy=CompactionPolicy(delta_fill=2.0, tombstone_ratio=2.0),
        max_out=900, seed=0).build(x[:300])
    q, r = x[::25], 2.0

    def answers():
        return [(res.ids.shape, res.neighbor_sets()) for res in
                (sh.query(q, r, force=f) for f in ("lsh", "linear"))]
    for grow in (lambda: None, lambda: sh.insert(x[300:303], shard=0),
                 lambda: sh.insert(x[303:340])):
        grow()
        got = answers()
        with monkeypatch.context() as mp:
            _full_capacity_delta(mp)
            assert answers() == got, sh.index_stats()["delta_per_shard"]
    st = sh.index_stats()
    assert min(st["delta_per_shard"]) > 0
    assert (st["delta_empty_batches"], st["delta_kernel_batches"]) == (8, 0)
