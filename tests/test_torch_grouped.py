"""The route estimate over all frozen segments (``ops.route_estimate``,
K3) and the grouped linear scan (``ops.grouped_linear_scan``, K5) of
``repro_torch`` against ``repro`` on the CPU.

The reference builds each index (its family draws, its op stream); the
port loads the reference's ``state_dict()`` (``interop``), so both hold
the same segments bit for bit.  Then:

  (a) ``ops.route_estimate``'s plain version against the reference's
      per-segment terms, and ``QueryEngine.estimate`` (through the
      index's ``estimate``) against the reference's: collisions exact,
      ``cand_est`` at rtol 2e-6 (the reference's CPU ``exp2`` is inexact
      for integer arguments >= 13), routes equal except where the LSH cost
      lies within 1e-5 (relative) of the linear cost;
  (b) ``ops.grouped_linear_scan``'s plain version and the engine's linear
      group against the reference's ``search_group(lsh_route=False)``,
      static and streaming, every metric: Hamming ids, masks and
      distances exactly equal; l2, cosine and L1 masks equal but within
      1e-5 (relative) of the threshold, ids equal and distances at 1e-5
      where both report;
  (c) the whole slice: ``query`` with force None, "lsh" and "linear" on
      both packages: buffers equal (Hamming exactly; L1 ids and masks
      exactly and distances at 1e-5) and neighbour sets equal.

The port's delta reports its first ``count`` slots, the rows written; the
reference reports all C + 1, whose last columns (never live) it masks.  So
the port's buffers are the reference's first columns, and the rest of the
reference's are masked, with sentinel ids.

The p-stable families use radius 1 (w = 4 for L1, 2 for l2: powers of
two), so the reference's jitted ``/ w`` and the port's division agree
exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.core import HybridLSHIndex as JIndex  # noqa: E402
from repro.core.lsh import make_family as jmake_family  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.streaming import CompactionPolicy as JPolicy  # noqa: E402
from repro.streaming import DynamicHybridIndex as JDyn  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import HybridLSHIndex  # noqa: E402
from repro_torch.core.engine import TableSegment  # noqa: E402
from repro_torch.core.index import as_rows  # noqa: E402
from repro_torch.core.lsh import make_family  # noqa: E402
from repro_torch.data import clustered_dataset, paper_dataset  # noqa: E402
from repro_torch.interop import (dynamic_index_from_state,  # noqa: E402
                                 params_from_numpy)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import EXT_SENTINEL  # noqa: E402
from repro_torch.streaming import CompactionPolicy  # noqa: E402

L, B, M, CAP, DCAP = 6, 128, 32, 2048, 128
RADII = {"l2": 0.5, "l1": 2.5, "cosine": 0.05, "hamming": 20.0}
# alpha per metric, beta = 1: the hybrid routes queries both ways
ALPHA = {"l2": 1.0, "l1": 3.0, "cosine": 1.0, "hamming": 1.5}
FANOUT = 16                           # level-0 segments accumulate
COST_TIE = 1e-5


def _data(metric, n=1200):
    if metric == "hamming":
        return paper_dataset("mnist", scale=0.02, seed=0)[0][:n]
    return clustered_dataset(n, 16, n_clusters=12, dense_core_frac=0.25,
                             core_scale=0.02, seed=0, metric=metric)


def _fam(make, metric):
    d = 64 if metric == "hamming" else 16
    return make(metric, d=d, L=L,
                r=1.0 if metric in ("l1", "l2") else RADII[metric])


def _queries(x):
    return np.ascontiguousarray(x[::37][:24])


_CHURNED = {}


def _cost(pkg, metric):
    return pkg.CostModel(alpha=ALPHA[metric], beta=1.0)


def _churned(metric):
    """A churned reference index (6 frozen level-0 segments: the build and
    five delta freezes; deletes in the segments and the delta; 60 rows
    left in the delta) and the port holding its state; built once."""
    if metric not in _CHURNED:
        x = _data(metric)
        ref = JDyn(_fam(jmake_family, metric), num_buckets=B, m=M, cap=CAP,
                   delta_capacity=DCAP, key=0,
                   cost_model=_cost(jcore, metric),
                   policy=JPolicy(fanout=FANOUT))
        ref.build(jnp.asarray(x[:500]))
        ref.insert(jnp.asarray(x[500:1200]))
        ref.delete(list(range(0, 500, 7)) + list(range(600, 1100, 13))
                   + list(range(1150, 1170)))
        port = dynamic_index_from_state(
            _fam(make_family, metric), ref.state_dict(), "cpu",
            num_buckets=B, m=M, cap=CAP, delta_capacity=DCAP,
            cost_model=_cost(tcore, metric),
            policy=CompactionPolicy(fanout=FANOUT))
        assert len(ref.stack.segments) >= 5 and port.delta.count > 0
        assert port.state_digests() == ref.state_digests()
        _CHURNED[metric] = (x, ref, port)
    return _CHURNED[metric]


def _dist64(metric, q, rows):
    if metric == "hamming":
        return np.unpackbits(np.bitwise_xor(rows, q[None, :]).view(np.uint8),
                             axis=1).sum(1).astype(float)
    return np.abs(rows.astype(np.float64) - q.astype(np.float64)).sum(1)


def _reference_frozen_sums(ref, jqb, tidx):
    """The reference's frozen segments' terms summed as the kernel sums
    them: collisions, and the estimates (less dead counts, clamped at 0)
    added in segment order from 0 in float32."""
    segs = ref._segments(tidx)[:-1]
    coll = np.zeros(jqb.shape[0], np.int64)
    cand = np.zeros(jqb.shape[0], np.float32)
    for s in segs:
        t = s.estimate_terms(jqb)
        coll += np.asarray(t.collisions)
        est = np.asarray(jops.hll_merge_estimate(t.registers, impl="ref"))
        if t.dead_collisions is not None:
            est = np.maximum(est - np.asarray(t.dead_collisions, np.float32),
                             np.float32(0))
        cand = (cand + est).astype(np.float32)
    return coll, cand


def _assert_estimates(ta, ja):
    np.testing.assert_array_equal(ta.collisions.numpy(),
                                  np.asarray(ja.collisions))
    np.testing.assert_allclose(ta.cand_est.numpy(), np.asarray(ja.cand_est),
                               rtol=2e-6)
    assert float(ta.linear_cost) == float(ja.linear_cost)
    lin = float(ja.linear_cost)
    tie = np.abs(np.asarray(ja.lsh_cost) - lin) <= COST_TIE * abs(lin)
    differ = ta.use_lsh.numpy() != np.asarray(ja.use_lsh)
    assert not (differ & ~tie).any()


@pytest.mark.parametrize("metric", ["hamming", "l1"])
def test_route_estimate_matches_reference_segments(metric):
    """(a) The plain route estimate over every frozen segment against the
    reference's per-segment terms, and the engine's estimate (one
    ``route_estimate`` for the frozen segments, then the delta's exact
    terms) against the reference's."""
    x, ref, port = _churned(metric)
    q = _queries(x)
    jqb, jt = ref._qbuckets(jnp.asarray(q), 1)
    qb, tidx = port._qbuckets(port._rows(q), 1)
    np.testing.assert_array_equal(qb.numpy(), np.asarray(jqb))
    frozen = [s for s in port._segments(tidx) if isinstance(s, TableSegment)]
    assert len(frozen) >= 5 and all(s.tomb_counts is not None for s in frozen)
    coll, cand = ops.route_estimate(qb, [s.table_terms() for s in frozen],
                                    tidx)
    want_coll, want_cand = _reference_frozen_sums(ref, jqb, jt)
    np.testing.assert_array_equal(coll.numpy(), want_coll)
    np.testing.assert_allclose(cand.numpy(), want_cand, rtol=2e-6)
    _assert_estimates(port.estimate(q), ref.estimate(jnp.asarray(q)))


@pytest.mark.parametrize("num_probes", [2, 4])
def test_route_estimate_multiprobe_matches_reference(num_probes):
    """(a) Cosine under multi-probe: V = L T probed columns mapped to
    tables by ``tidx``, in every frozen segment and the delta."""
    x = _data("cosine")
    ref = JDyn(_fam(jmake_family, "cosine"), num_buckets=B, m=M, cap=CAP,
               delta_capacity=DCAP, key=0,
               cost_model=_cost(jcore, "cosine"), policy=JPolicy(fanout=FANOUT))
    ref.build(jnp.asarray(x[:600]))
    ref.insert(jnp.asarray(x[600:1000]))
    ref.delete(list(range(0, 1000, 9)))
    port = dynamic_index_from_state(
        _fam(make_family, "cosine"), ref.state_dict(), "cpu", num_buckets=B,
        m=M, cap=CAP, delta_capacity=DCAP, cost_model=_cost(tcore, "cosine"),
        policy=CompactionPolicy(fanout=FANOUT))
    q = _queries(x)
    jqb, jt = ref._qbuckets(jnp.asarray(q), num_probes)
    qb, tidx = port._qbuckets(port._rows(q), num_probes)
    assert qb.shape[1] == L * num_probes and tidx is not None
    frozen = [s for s in port._segments(tidx) if isinstance(s, TableSegment)]
    coll, cand = ops.route_estimate(qb, [s.table_terms() for s in frozen],
                                    tidx)
    want_coll, want_cand = _reference_frozen_sums(ref, jqb, jt)
    np.testing.assert_array_equal(coll.numpy(), want_coll)
    np.testing.assert_allclose(cand.numpy(), want_cand, rtol=2e-6)
    _assert_estimates(port.estimate(q, num_probes=num_probes),
                      ref.estimate(jnp.asarray(q), num_probes=num_probes))


def _static_pair(metric):
    x = _data(metric)
    ref = JIndex(_fam(jmake_family, metric), num_buckets=B, m=M, cap=CAP,
                 key=0, cost_model=_cost(jcore, metric))
    ref.build(jnp.asarray(x))
    port = HybridLSHIndex(
        _fam(make_family, metric), num_buckets=B, m=M, cap=CAP,
        cost_model=_cost(tcore, metric), device="cpu",
        params=params_from_numpy({k: np.asarray(v)
                                  for k, v in ref.params.items()}, "cpu"))
    port.build(x)
    return x, ref, port


@pytest.mark.parametrize("metric", ["hamming", "l2", "cosine", "l1"])
@pytest.mark.parametrize("kind", ["static", "streaming"])
def test_grouped_linear_scan_matches_reference_search_group(kind, metric):
    """(b) The linear route of a whole group over every segment: the plain
    grouped scan and the engine's ``search_group`` against the
    reference's ``search_group(lsh_route=False)``, Hamming exactly, the
    float metrics' reported pairs up to the threshold's rounding."""
    if kind == "static":
        x, ref, port = _static_pair(metric)
        jsegs, segs = [ref._segment()], [port._segment()]
        jqb = ref._bucket_fn(ref.params, jnp.asarray(_queries(x)))
        qb = port.bucket_ids(as_rows(_queries(x), metric, "cpu"))
    else:
        x, ref, port = _churned(metric)
        jqb, _ = ref._qbuckets(jnp.asarray(_queries(x)), 1)
        jsegs = ref._segments(None)
        qb, _ = port._qbuckets(port._rows(_queries(x)), 1)
        segs = port._segments(None)
    q = _queries(x)
    r = RADII[metric]
    want = ref._engine.search_group(jsegs, jqb, jnp.asarray(q), r,
                                    lsh_route=False)
    tq = as_rows(q, metric, "cpu")
    plain = ops.grouped_linear_scan(tq, [s.scan_part() for s in segs], r,
                                    metric)
    got = port._engine.search_group(segs, qb, tq, r, lsh_route=False)
    assert all(torch.equal(u, v) for u, v in zip(plain, got))
    width = sum(s.scan_part().x.shape[0] for s in segs)
    assert plain[0].shape == (len(q), width)
    ids, dists, mask = (np.asarray(v)[:, :width] for v in want)
    got_ids, got_d, got_mask = (t.numpy() for t in plain)
    if metric == "hamming":
        for u, v in ((got_ids, ids), (got_d, dists), (got_mask, mask)):
            np.testing.assert_array_equal(u, v)
    else:
        t = ops.metric_radius_transform(metric, r)
        near = np.abs(got_d - t) <= 1e-5 * max(1.0, t)
        assert not ((got_mask != mask) & ~near).any()
        both = got_mask & mask
        np.testing.assert_array_equal(got_ids[both], ids[both])
        np.testing.assert_allclose(got_d[both], dists[both], rtol=1e-5,
                                   atol=1e-5)
    _assert_masked_past(want, width,
                        DCAP + 1 - port.delta.count if kind == "streaming"
                        else 0)
    assert bool(plain[2].any()) and not bool(plain[2].all())


def _assert_masked_past(buffers, width, extra):
    """The reference's (ids, dists, mask) has ``extra`` columns past the
    port's ``width`` (its delta's slots past the count), all masked."""
    ids, _, mask = (np.asarray(v) for v in buffers)
    assert ids.shape[1] == width + extra
    assert not mask[:, width:].any() and (ids[:, width:] == EXT_SENTINEL).all()


@pytest.mark.parametrize("force", [None, "lsh", "linear"])
@pytest.mark.parametrize("metric", ["hamming", "l1"])
def test_churned_query_slice_matches_reference(metric, force):
    """(c) The whole slice on a churned index: the port's ``query`` (one
    route estimate over all frozen segments, one grouped linear scan)
    against the reference's: routes, and for every query that both
    route alike (all but cost ties) its buffer row (the reference pads
    each group to a power of two by repeating its last query) and its
    neighbour set.  Hamming distances are exact; L1 masks may differ
    only within 1e-5 (relative) of the threshold, where the two packages'
    float32 sums in different orders may round a row across it."""
    x, ref, port = _churned(metric)
    q = _queries(x)
    r = RADII[metric]
    a = port.query(q, r, force=force)
    b = ref.query(jnp.asarray(q), r, force=force)
    _assert_estimates(a.route, b.route)
    same = a.route.use_lsh.numpy() == np.asarray(b.route.use_lsh)
    compared = 0
    for ta, tidx, jb, jidx in ((a.lsh_out, a.lsh_idx, b.lsh_out, b.lsh_idx),
                               (a.lin_out, a.lin_idx, b.lin_out, b.lin_idx)):
        if ta is None:
            continue
        ref_row = {}                  # query -> its first row in repro's group
        for k, i in enumerate(np.asarray(jidx) if jb is not None else ()):
            ref_row.setdefault(int(i), k)
        rows = [(k, ref_row[int(i)]) for k, i in enumerate(tidx)
                if int(i) in ref_row]        # routed alike (not a cost tie)
        if not rows:
            continue
        ks, js = (np.array(v) for v in zip(*rows))
        _assert_masked_past(jb, ta[0].shape[1],
                            DCAP + 1 - port.delta.count)
        ids, dists, mask = (np.asarray(v)[js][:, :ta[0].shape[1]]
                            for v in jb)
        got_ids, got_d, got_mask = (t.numpy()[ks] for t in ta)
        if metric == "hamming":
            near = np.zeros_like(mask)
        else:
            near = np.abs(got_d - r) <= 1e-5 * max(1.0, r)
        assert not ((got_mask != mask) & ~near).any()
        both = got_mask & mask
        np.testing.assert_array_equal(got_ids[both], ids[both])
        np.testing.assert_allclose(got_d[both], dists[both], rtol=1e-5,
                                   atol=1e-5)
        compared += len(rows)
    assert compared == int(same.sum())
    for i in range(len(q)):
        if not same[i]:
            continue
        sa, sb = set(a.neighbors(i).tolist()), set(
            np.asarray(b.neighbors(i)).tolist())
        diff = np.array(sorted(sa ^ sb), np.int64)
        if len(diff):
            assert metric != "hamming", (i, diff)
            d = _dist64(metric, q[i], x[diff])
            assert np.all(np.abs(d - r) <= 1e-5 * max(1.0, r)), (i, diff, d)
