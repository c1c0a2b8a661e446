"""Parity of ``repro_torch.streaming`` with ``repro.streaming`` on the CPU.

The same numpy rows and the reference's family parameters go through
both packages' ``DynamicHybridIndex`` under the same op stream: build,
inserts that cross the delta capacity (level-0 freezes, a level
overflow), deletes in frozen segments and in the delta, budgeted
``compact_step`` merges with a query and a delete mid-merge, and a full
``compact``.  After every step:

  * integer and bool state is bit-identical (bucket ids, CSR tables,
    registers, tombstone ``live``/``counts``, delta ids and live, the
    metadata) and the rows are equal;
  * ``state_digests()`` are equal;
  * ``neighbor_sets()`` are identical for force "lsh" and "linear", and
    for the hybrid on every query whose route agrees (rows within 1e-5
    of the threshold may differ: the two sides round float32 sums in
    different orders); the route agreement rate is printed;
  * reported distances are allclose at rtol = atol = 1e-5.

The p-stable families are made with radius 1 (w = 2 for l2, 4 for l1):
a power-of-two w makes the reference's jitted ``/ w`` and the port's
true division agree exactly, so the bucket ids can be held bit-equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core.lsh import make_family as jmake_family  # noqa: E402
from repro.streaming import CompactionPolicy as JPolicy  # noqa: E402
from repro.streaming import DynamicHybridIndex as JDyn  # noqa: E402
from repro.streaming import tombstones as jtomb  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.core.lsh import make_family  # noqa: E402
from repro_torch.data import clustered_dataset, paper_dataset  # noqa: E402
from repro_torch.interop import (dynamic_index_from_state,  # noqa: E402
                                 params_from_numpy)
from repro_torch.streaming import CompactionDriver, CompactionPolicy  # noqa: E402
from repro_torch.streaming import DynamicHybridIndex  # noqa: E402
from repro_torch.streaming import tombstones as ttomb  # noqa: E402
from harness import decode_ops  # noqa: E402

REL = 1e-5          # rows this close (relative) to the threshold may flip
DIST_TOL = dict(rtol=1e-5, atol=1e-5)
L, B, M, CAP, DCAP = 6, 128, 32, 2048, 128
# metric -> query radius; beta/alpha = 1 so both routes win queries
RADII = {"l2": 0.45, "cosine": 0.05, "l1": 2.5, "hamming": 16.0}
METRICS = ["l2", "l1", "cosine", "hamming"]
INT_LEAVES = ("ids", "bucket_ids", "perm", "starts", "registers", "live",
              "tomb_counts")


def _data(metric, n=1200):
    if metric == "hamming":
        words, _ = paper_dataset("mnist", scale=0.02, seed=0)   # n = 1200
        return words[:n]
    return clustered_dataset(n, 16, n_clusters=12, dense_core_frac=0.25,
                             core_scale=0.02, seed=0, metric=metric)


def _fam_args(metric):
    d = 64 if metric == "hamming" else 16
    # p-stable: radius 1 gives a power-of-two w; the others derive k
    r = 1.0 if metric in ("l2", "l1") else RADII[metric]
    return dict(d=d, L=L, r=r)


def _pair(metric, policy_kw=None, cap=CAP):
    """A reference index and a port index sharing its params."""
    policy_kw = policy_kw or {}
    ref = JDyn(jmake_family(metric, **_fam_args(metric)), num_buckets=B, m=M,
               cap=cap, delta_capacity=DCAP, key=0,
               cost_model=jcore.CostModel(alpha=1.0, beta=1.0),
               policy=JPolicy(**policy_kw))
    port = DynamicHybridIndex(
        make_family(metric, **_fam_args(metric)), num_buckets=B, m=M,
        cap=cap, delta_capacity=DCAP,
        cost_model=tcore.CostModel(alpha=1.0, beta=1.0),
        policy=CompactionPolicy(**policy_kw),
        params=params_from_numpy({k: np.asarray(v)
                                  for k, v in ref.params.items()}, "cpu"),
        device="cpu")
    return ref, port


def _dist64(metric, q, rows):
    """Exact float64 distances (squared for l2) of rows to one query."""
    if metric == "hamming":
        x = np.bitwise_xor(rows, q[None, :])
        return np.unpackbits(x.view(np.uint8), axis=1).sum(1).astype(float)
    q = q.astype(np.float64)
    rows = rows.astype(np.float64)
    if metric == "l2":
        return ((rows - q) ** 2).sum(1)
    if metric == "l1":
        return np.abs(rows - q).sum(1)
    qn = q / max(np.linalg.norm(q), 1e-12)
    rn = rows / np.maximum(np.linalg.norm(rows, axis=1, keepdims=True), 1e-12)
    return 1.0 - rn @ qn


class IndexMirror:
    """One op stream applied to a reference and a port index, every
    observable compared after each op (``harness.MirrorOracle`` does
    this for serving stacks; this is its counterpart for two indexes).
    ``corpus`` maps external ids to rows for the threshold check."""

    def __init__(self, metric, ref, port, queries):
        self.metric, self.ref, self.port = metric, ref, port
        self.queries = queries
        self.corpus = {}
        self.r = RADII[metric]
        self.route_agree = []
        self.checks = 0

    # ---------------------------------------------------------- ops
    def build(self, x):
        self.ref.build(jnp.asarray(x))
        self.port.build(x)
        self.corpus = dict(enumerate(x))
        self.check()

    def insert(self, rows):
        a = self.ref.insert(jnp.asarray(rows))
        b = self.port.insert(rows)
        np.testing.assert_array_equal(a, b)
        self.corpus.update(zip(b.tolist(), rows))
        self.check()

    def delete(self, ids):
        assert self.ref.delete(ids) == self.port.delete(ids)
        self.check()

    def compact_step(self, budget):
        assert self.ref.compact_step(budget) == self.port.compact_step(budget)
        self.check()

    def compact(self):
        self.ref.compact()
        self.port.compact()
        self.check()

    # ------------------------------------------------------- checks
    def check(self):
        self.check_state()
        self.check_queries()
        self.checks += 1

    def check_state(self):
        a, b = self.ref.state_dict(), self.port.state_dict()
        assert sorted(a["segments"]) == sorted(b["segments"])
        for key, sa in a["segments"].items():
            sb = b["segments"][key]
            np.testing.assert_array_equal(np.asarray(sa["x"]), sb["x"])
            assert np.asarray(sa["x"]).dtype == sb["x"].dtype
            for leaf in INT_LEAVES:
                np.testing.assert_array_equal(np.asarray(sa[leaf]), sb[leaf],
                                              err_msg=f"{key}/{leaf}")
                assert np.asarray(sa[leaf]).dtype == sb[leaf].dtype, leaf
            assert {k: int(v) for k, v in sa["meta"].items()} == \
                {k: int(v) for k, v in sb["meta"].items()}
        for leaf in ("x", "bucket_ids", "ids", "live", "count"):
            np.testing.assert_array_equal(np.asarray(a["delta"][leaf]),
                                          b["delta"][leaf],
                                          err_msg=f"delta/{leaf}")
        assert {k: int(v) for k, v in a["meta"].items()} == \
            {k: int(v) for k, v in b["meta"].items()}
        assert self.ref.state_digests() == self.port.state_digests()
        sa, sb = self.ref.index_stats(), self.port.index_stats()
        for k in ("n_live", "n_main", "n_main_dead", "delta_count",
                  "delta_live", "segments", "levels", "pending_merges",
                  "freezes", "compactions", "merges_per_level"):
            assert sa[k] == sb[k], (k, sa[k], sb[k])
        assert self.ref.version == self.port.version

    def assert_sets(self, a, b, i):
        diff = np.array(sorted(a ^ b), np.int64)
        if len(diff):
            t = self.r * self.r if self.metric == "l2" else self.r
            rows = np.stack([self.corpus[int(e)] for e in diff])
            d = _dist64(self.metric, self.queries[i], rows)
            assert np.all(np.abs(d - t) <= REL * max(1.0, abs(t))), \
                (i, diff, d, t)

    def check_queries(self):
        q = self.queries
        ja = self.ref.estimate(jnp.asarray(q))
        ta = self.port.estimate(q)
        np.testing.assert_array_equal(ta.collisions.numpy(),
                                      np.asarray(ja.collisions))
        np.testing.assert_allclose(ta.cand_est.numpy(), np.asarray(ja.cand_est),
                                   rtol=1e-5)
        assert float(ta.linear_cost) == float(ja.linear_cost)
        same_route = ta.use_lsh.numpy() == np.asarray(ja.use_lsh)
        self.route_agree.append(float(same_route.mean()))
        for force in (None, "lsh", "linear"):
            res_a = self.ref.query(jnp.asarray(q), self.r, force=force)
            res_b = self.port.query(q, self.r, force=force)
            for i in range(len(q)):
                if force is None and not same_route[i]:
                    continue
                ia, da = (np.asarray(v) for v in res_a.reported(i))
                ib, db = res_b.reported(i)
                sa, sb = set(ia.tolist()), set(ib.tolist())
                self.assert_sets(sa, sb, i)
                common = sorted(sa & sb)
                pa = dict(zip(ia.tolist(), da.tolist()))
                pb = dict(zip(ib.tolist(), db.tolist()))
                np.testing.assert_allclose([pb[c] for c in common],
                                           [pa[c] for c in common],
                                           **DIST_TOL)


def _queries(metric, x):
    rng = np.random.default_rng(7)
    return x[rng.choice(len(x), 24, replace=False)]


@pytest.mark.parametrize("metric", METRICS)
def test_op_stream_parity(metric):
    """The scripted op stream of the module docstring, step by step."""
    x = _data(metric)
    ref, port = _pair(metric, dict(fanout=2, step_rows=64,
                                   tombstone_ratio=2.0))
    mir = IndexMirror(metric, ref, port, _queries(metric, x))
    mir.build(x[:600])
    mir.insert(x[600:700])                 # delta only
    mir.insert(x[700:900])                 # crosses capacity: freezes
    mir.delete(list(range(0, 60, 3))       # the built segment
               + list(range(610, 640, 2))  # a level-0 segment
               + [890, 895, 10**6])        # the delta, an unknown id
    mir.insert(x[900:1100])                # level 0 overflows: merge queued
    assert port.pending_merges >= 1
    mir.compact_step(50)                   # a query mid-merge (check)
    staged = port.staged_rows
    assert 0 < staged
    mir.delete([640, 642, 700, 750, 1, 4])  # deletes during the merge
    while port.has_compaction_work:
        mir.compact_step(80)
    mir.delete(list(range(1000, 1040)))
    mir.insert(x[1100:])
    mir.compact()                          # full fold
    assert port.index_stats()["segments"] == 1
    rate = float(np.mean(mir.route_agree))
    print(f"{metric}: {mir.checks} checkpoints, hybrid route agreement "
          f"{rate:.4f}")
    assert rate >= 0.95


@pytest.mark.parametrize("metric", ["l2", "hamming"])
def test_decoded_op_stream_parity(metric):
    """A random op stream decoded by ``harness.decode_ops``: create ->
    build, insert, delete, query, compact -> a budgeted step, drop ->
    a full compact; state and sets compared after every op."""
    x = _data(metric)
    ref, port = _pair(metric, dict(fanout=2, step_rows=48,
                                   tombstone_ratio=0.3))
    mir = IndexMirror(metric, ref, port, _queries(metric, x)[:12])
    ints = np.random.default_rng(11).integers(0, 2**31, 28)
    nxt = 0
    for kind, _, arg in decode_ops(ints, names=("a",)):
        if kind == "create":
            nxt = 300 + arg % 200
            mir.build(x[:nxt])
        elif kind == "insert" and nxt < len(x):
            k = 20 + arg % 150
            mir.insert(x[nxt:nxt + k])
            nxt = min(len(x), nxt + k)
        elif kind == "delete":
            live = sorted(port._loc)
            k = 1 + arg % 30
            off = arg % max(len(live), 1)
            mir.delete([live[(off + 7 * j) % len(live)] for j in range(k)])
        elif kind == "query":
            mir.check()
        elif kind == "compact":
            mir.compact_step(1 + arg % 100)
        else:                                   # drop
            mir.compact()
    print(f"{metric}: {mir.checks} checkpoints over {len(ints)} ops, route "
          f"agreement {np.mean(mir.route_agree):.4f}")


@pytest.mark.parametrize("metric", METRICS)
def test_port_loads_reference_state(metric):
    """A port index loaded from the reference's ``state_dict()`` (taken
    mid-churn, a merge pending) reports the reference's sets."""
    x = _data(metric)
    ref, _ = _pair(metric, dict(fanout=2, step_rows=32, tombstone_ratio=2.0))
    ref.build(jnp.asarray(x[:500]))
    ref.insert(jnp.asarray(x[500:900]))
    ref.delete(list(range(0, 500, 7)) + list(range(880, 900)))
    ref.compact_step(40)
    port = dynamic_index_from_state(
        make_family(metric, **_fam_args(metric)), ref.state_dict(), "cpu",
        num_buckets=B, m=M, cap=CAP, delta_capacity=DCAP,
        cost_model=tcore.CostModel(alpha=1.0, beta=1.0),
        policy=CompactionPolicy(fanout=2, step_rows=32,
                                tombstone_ratio=2.0))
    mir = IndexMirror(metric, ref, port, _queries(metric, x))
    mir.corpus = dict(enumerate(x))
    # the reference's staged merge progress is volatile: restore drops it
    ref.stack.tasks = []
    mir.check_queries()
    assert port.n == ref.n and port.state_digests() == ref.state_digests()
    # the port's own state_dict round-trips through itself
    again = DynamicHybridIndex(
        make_family(metric, **_fam_args(metric)), num_buckets=B, m=M,
        cap=CAP, device="cpu").load_state_dict(port.state_dict())
    assert again.state_digests() == port.state_digests()
    q = _queries(metric, x)
    for f in ("lsh", "linear"):
        assert again.query(q, RADII[metric], force=f).neighbor_sets() == \
            port.query(q, RADII[metric], force=f).neighbor_sets()


@pytest.mark.parametrize("num_probes", [2, 3])
def test_multiprobe_matches_reference(num_probes):
    x = _data("cosine")
    ref, port = _pair("cosine")
    ref.build(jnp.asarray(x[:900]))
    port.build(x[:900])
    ref.insert(jnp.asarray(x[900:]))
    port.insert(x[900:])
    q = _queries("cosine", x)
    r = RADII["cosine"]
    from repro.core import multiprobe as jmp
    from repro_torch.core import multiprobe as tmp
    jb = jmp.probe_buckets(ref.family, ref.params, jnp.asarray(q), num_probes,
                           B)
    tb = tmp.probe_buckets(port.family, port.params, torch.from_numpy(q),
                           num_probes, B)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    jt, tt = ref.stack.segments[0].seg.tables, port.stack.segments[0].seg.tables
    for jf, tf in ((jmp.multiprobe_counts, tmp.multiprobe_counts),
                   (jmp.multiprobe_registers, tmp.multiprobe_registers)):
        np.testing.assert_array_equal(tf(tt, tb).numpy(),
                                      np.asarray(jf(jt, jb)))
    np.testing.assert_array_equal(
        tmp.multiprobe_candidates(tt, tb, 8, tt.n).numpy(),
        np.asarray(jmp.multiprobe_candidates(jt, jb, 8, jt.n)))
    for force in ("lsh", "linear", None):
        a = port.query(q, r, force=force, num_probes=num_probes)
        b = ref.query(jnp.asarray(q), r, force=force, num_probes=num_probes)
        assert a.neighbor_sets() == b.neighbor_sets(), force
        np.testing.assert_array_equal(a.route.collisions.numpy(),
                                      np.asarray(b.route.collisions))
    one = port.query(q, r, force="lsh")
    many = port.query(q, r, force="lsh", num_probes=num_probes)
    a, b = one.neighbor_sets(), many.neighbor_sets()
    assert all(a[i] <= b[i] for i in a)
    assert int(many.route.collisions.sum()) > int(one.route.collisions.sum())


def test_tombstone_counts_accumulate_duplicate_buckets():
    """Rows sharing (table, bucket) pairs each add one dead count."""
    rng = np.random.default_rng(5)
    n, Lt, Bt = 40, 3, 4                   # 4 buckets: many shared pairs
    buckets = rng.integers(0, Bt, (n, Lt)).astype(np.int32)
    rows = np.array([0, 3, 3, 5, 8, 9, 12, 20, 21, 22, 39, 0], np.int32)
    valid = np.ones(len(rows), bool)
    valid[-1] = False                       # a padded lane adds nothing
    j = jtomb.mark_dead(jtomb.make_tombstones(n, Lt, Bt), jnp.asarray(rows),
                        jnp.asarray(buckets[rows]), jnp.asarray(valid))
    t = ttomb.mark_dead(ttomb.make_tombstones(n, Lt, Bt),
                        torch.from_numpy(rows),
                        torch.from_numpy(buckets[rows]),
                        torch.from_numpy(valid))
    np.testing.assert_array_equal(t.counts.numpy(), np.asarray(j.counts))
    np.testing.assert_array_equal(t.live.numpy(), np.asarray(j.live))
    assert int(t.counts.sum()) == Lt * int(valid.sum())
    q = rng.integers(0, Bt, (6, Lt)).astype(np.int32)
    np.testing.assert_array_equal(
        ttomb.dead_in_buckets(t, torch.from_numpy(q)).numpy(),
        np.asarray(jtomb.dead_in_buckets(j, jnp.asarray(q))))


@pytest.mark.parametrize("max_out", [1, 4, 9])
def test_compact_results_ties_match_reference(max_out):
    """Equal distances keep the reference's order (lower column first)."""
    d = np.array([[0.5, 0.1, 0.5, 0.1, 0.3, 0.1, 9.0, 0.5, 0.2],
                  [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0],
                  [0.0, 2.0, 0.0, 2.0, 0.0, 2.0, 0.0, 2.0, 0.0]], np.float32)
    mask = np.array([[1, 1, 1, 1, 0, 1, 1, 1, 1],
                     [0, 1, 0, 1, 1, 1, 0, 1, 1],
                     [1, 0, 1, 1, 1, 1, 0, 1, 1]], bool)
    ids = np.arange(d.size, dtype=np.int32).reshape(d.shape) + 100
    a = tengine.compact_results(torch.from_numpy(ids), torch.from_numpy(d),
                                torch.from_numpy(mask), max_out)
    b = jengine.compact_results(jnp.asarray(ids), jnp.asarray(d),
                                jnp.asarray(mask), max_out)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u.numpy(), np.asarray(v))


def test_estimate_wrappers_match_reference():
    """``estimate_routes`` and the tombstone-corrected
    ``estimate_routes_dynamic`` against the reference's."""
    x = _data("l2")
    ref, port = _pair("l2")
    ref.build(jnp.asarray(x[:800]))
    port.build(x[:800])
    ref.delete(range(0, 800, 5))
    port.delete(range(0, 800, 5))
    jf, tf = ref.stack.segments[0], port.stack.segments[0]
    q = _queries("l2", x)
    jq = ref._bucket_fn(ref.params, jnp.asarray(q))
    tq = port._bucket_fn(port.params, torch.from_numpy(q))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    rng = np.random.default_rng(2)
    dc = rng.integers(0, 30, len(q)).astype(np.int32)
    dd = np.minimum(dc, rng.integers(0, 20, len(q))).astype(np.int32)
    jcm, tcm = jcore.CostModel(1.0, 6.0), tcore.CostModel(1.0, 6.0)
    outs = [
        (tengine.estimate_routes(tf.seg.tables, tq, tcm, 800),
         jengine.estimate_routes(jf.seg.tables, jq, jcm, 800)),
        (tengine.estimate_routes_dynamic(
            tf.seg.tables, tq, tcm, tf.n_live, tomb_counts=tf.tomb.counts,
            delta_collisions=torch.from_numpy(dc),
            delta_distinct=torch.from_numpy(dd), n_scan=tf.n_pad),
         jengine.estimate_routes_dynamic(
            jf.seg.tables, jq, jcm, jf.n_live, tomb_counts=jf.tomb.counts,
            delta_collisions=jnp.asarray(dc), delta_distinct=jnp.asarray(dd),
            n_scan=jf.n_pad))]
    for te, je in outs:
        np.testing.assert_array_equal(te.collisions.numpy(),
                                      np.asarray(je.collisions))
        np.testing.assert_allclose(te.cand_est.numpy(),
                                   np.asarray(je.cand_est), rtol=1e-5)
        np.testing.assert_array_equal(te.use_lsh.numpy(),
                                      np.asarray(je.use_lsh))
        assert float(te.linear_cost) == float(je.linear_cost)


def test_churned_index_matches_fresh_static_index():
    """After churn (and after a full compact), the streaming port
    reports what a fresh port ``HybridLSHIndex`` built on the surviving
    rows reports, per route, with external ids mapped (cap generous)."""
    x = _data("l1")
    _, port = _pair("l1", dict(fanout=2, step_rows=None))
    port.build(x[:700])
    port.insert(x[700:])
    dead = list(range(3, 700, 9)) + list(range(700, 1200, 13))
    port.delete(dead)
    live = np.setdiff1d(np.arange(len(x)), dead)
    fresh = tcore.HybridLSHIndex(port.family, num_buckets=B, m=M, cap=CAP,
                                 params=port.params, device="cpu").build(
                                     x[live])
    q = _queries("l1", x)
    r = RADII["l1"]
    for step in ("churned", "compacted"):
        for f in ("lsh", "linear"):
            got = port.query(q, r, force=f).neighbor_sets()
            want = fresh.query(q, r, force=f).neighbor_sets()
            want = {i: {int(live[j]) for j in s} for i, s in want.items()}
            assert got == want, (step, f)
            assert not set().union(*got.values()) & set(dead)
        port.compact()


def test_driver_churn_matches_synchronous_reference():
    """The copied ``CompactionDriver`` stages and pre-builds merges on a
    worker thread while the control thread churns and queries; at the
    drained state the port reports the synchronously compacted
    reference's sets."""
    x = _data("l2")
    ref, port = _pair("l2", dict(fanout=2, step_rows=40,
                                 tombstone_ratio=2.0))
    q = _queries("l2", x)
    r = RADII["l2"]
    ref.build(jnp.asarray(x[:400]))
    port.build(x[:400])
    drv = CompactionDriver(port, budget_rows=40, poll_s=0.001).start()
    try:
        for lo in range(400, 1200, 100):
            ref.insert(jnp.asarray(x[lo:lo + 100]))
            port.insert(x[lo:lo + 100])
            victims = list(range(lo - 50, lo - 40))
            ref.delete(victims)
            port.delete(victims)
            drv.notify()
            port.query(q, r)
            drv.drain()
        drv.stop(flush=True)
    finally:
        drv.stop()
    while ref.compact_step(10**6):
        pass
    st = drv.stats()
    assert st["worker_errors"] == 0 and not st["worker_alive"]
    assert st["applied"] >= 1
    assert not port.has_compaction_work
    for f in ("lsh", "linear"):
        assert port.query(q, r, force=f).neighbor_sets() == \
            ref.query(jnp.asarray(q), r, force=f).neighbor_sets(), f


def test_traced_query_records_spans_and_matches_untraced():
    from repro_torch.obs import Observability
    x = _data("l2")
    _, port = _pair("l2")
    obs = Observability.create(enabled=True)
    traced = DynamicHybridIndex(port.family, num_buckets=B, m=M, cap=CAP,
                                delta_capacity=DCAP, params=port.params,
                                obs=obs, device="cpu")
    for idx in (port, traced):
        idx.build(x[:900])
        idx.insert(x[900:])
    q = _queries("l2", x)
    obs.tracer.per_segment_timing = True
    obs.tracer.sample_every = 1            # trace every batch
    for f in (None, "lsh", "linear"):
        a = traced.query(q, RADII["l2"], force=f)
        b = port.query(q, RADII["l2"], force=f)
        assert a.neighbor_sets() == b.neighbor_sets()
    spans = obs.tracer.spans()
    assert len(spans) == 3 * len(q)
    from repro_torch.obs import to_prometheus
    assert 'impl="ref"' in to_prometheus(obs.registry)
    assert obs.events.counts_by_kind()["freeze"] >= 1


def test_empty_and_default_device():
    fam = make_family("l2", d=4, L=2, r=1.0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            DynamicHybridIndex(fam, num_buckets=16)
    idx = DynamicHybridIndex(fam, num_buckets=16, device="cpu")
    with pytest.raises(RuntimeError, match="empty"):
        idx.query(np.zeros((1, 4), np.float32), 1.0)
    rows = np.random.default_rng(0).normal(size=(5, 4)).astype(np.float32)
    ids = idx.insert(rows)                  # first contact: delta only
    assert ids.tolist() == [0, 1, 2, 3, 4] and idx.n == 5
    assert idx.query(rows, 1e-3, force="linear").neighbor_sets() == \
        {i: {i} for i in range(5)}
    with pytest.raises(KeyError):
        idx.insert(rows[:1], ids=[2])
