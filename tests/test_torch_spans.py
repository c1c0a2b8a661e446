"""The port's profiler spans and query counters (``repro_torch.obs.spans``,
``QueryEngine.stats``, ``index_stats()``) on CPU indexes: under
``torch.profiler`` each query is one ``hlsh.query`` with its phases
nested inside; without a profiler no range is opened; results do not
depend on either; the engine counts its batches and blocking copies."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.core import CostModel, HybridLSHIndex  # noqa: E402
from repro_torch.core.lsh import make_family  # noqa: E402
from repro_torch.data import clustered_dataset, query_split  # noqa: E402
from repro_torch.obs import Observability  # noqa: E402
from repro_torch.obs import spans as spans_lib  # noqa: E402
from repro_torch.streaming import CompactionPolicy, DynamicHybridIndex  # noqa: E402

R = 0.45            # with beta/alpha = 1 the dense core routes linear
COSINE_R = 0.05     # the same for SimHash, a hash with no blocking copy
FORCES = (None, "lsh", "linear")
PHASES = {"hlsh.hash", "hlsh.estimate", "hlsh.route", "hlsh.search.lsh",
          "hlsh.search.linear"}


@pytest.fixture(scope="module")
def data():
    x = clustered_dataset(2048, 32, n_clusters=16, dense_core_frac=0.25,
                          core_scale=0.02, seed=0, metric="l2")
    return query_split(x, n_queries=40, seed=0)


def _static(x, obs=None, metric="l2", r=R):
    fam = make_family(metric, d=x.shape[1], L=8, r=r)
    return HybridLSHIndex(fam, num_buckets=256, m=64, cap=64,
                          cost_model=CostModel(alpha=1.0, beta=1.0),
                          obs=obs, device="cpu").build(x)


def _streaming(x, metric="l2", r=R):
    """A built frozen segment and a delta holding rows."""
    fam = make_family(metric, d=x.shape[1], L=8, r=r)
    idx = DynamicHybridIndex(fam, num_buckets=256, m=64, cap=64,
                             delta_capacity=512,
                             cost_model=CostModel(alpha=1.0, beta=1.0),
                             policy=CompactionPolicy(delta_fill=1.0),
                             device="cpu")
    idx.build(x[:1800])
    idx.insert(x[1800:])
    assert idx.index_stats()["delta_live"] > 0
    return idx


KINDS = {"static": _static, "streaming": _streaming}


def _hlsh(prof):
    return [e for e in prof.events() if e.name.startswith("hlsh.")]


def _chain(e):
    out = []
    while e.cpu_parent is not None:
        e = e.cpu_parent
        out.append(e.name)
    return out


def _answers(res):
    return {i: sorted(zip(*(a.tolist() for a in res.reported(i))))
            for i in range(res.n_queries)}


@pytest.mark.parametrize("force", FORCES)
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_spans_nest_under_one_query_span_per_call(data, kind, force):
    x, q = data
    idx = KINDS[kind](x)
    plain = idx.query(q, R, force=force)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = [idx.query(q, R, force=force) for _ in range(2)]
    ev = _hlsh(prof)
    assert sum(e.name == "hlsh.query" for e in ev) == 2
    names = {e.name for e in ev}
    want = {"hlsh.query", "hlsh.hash", "hlsh.estimate", "hlsh.route"}
    if len(plain.lsh_idx):
        want.add("hlsh.search.lsh")
    if len(plain.lin_idx):
        want.add("hlsh.search.linear")
    if kind == "streaming":
        want.add("hlsh.delta.counts")
        if len(plain.lsh_idx):
            want.add("hlsh.delta.search")
    assert names == want
    assert names <= set(spans_lib.SPANS)
    for e in ev:
        chain = _chain(e)
        if e.name == "hlsh.query":
            assert not any(n.startswith("hlsh.") for n in chain)
            continue
        assert chain.count("hlsh.query") == 1, (e.name, chain)
        if e.name in PHASES:
            assert chain[0] == "hlsh.query", (e.name, chain)
        elif e.name == "hlsh.delta.counts":
            assert chain[0] == "hlsh.estimate"
        else:
            assert chain[0] in ("hlsh.search.lsh", "hlsh.search.linear")
    for res in traced:
        assert _answers(res) == _answers(plain)
        np.testing.assert_array_equal(res.lsh_idx, plain.lsh_idx)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_build_span_and_seconds(data, kind):
    x, _ = data
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        idx = KINDS[kind](x)
    builds = [e for e in _hlsh(prof) if e.name == "hlsh.build"]
    assert len(builds) == 1
    secs = idx.index_stats()["build_seconds"]
    assert 0.0 < secs <= builds[0].time_range.elapsed_us() * 1e-6 + 1e-3


def test_no_range_is_opened_without_a_profiler(data, monkeypatch):
    x, q = data
    assert spans_lib.span("hlsh.query") is spans_lib.span("hlsh.hash")
    opened = []
    real = spans_lib._RANGE

    def counting(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(spans_lib, "_RANGE", counting)
    for make in KINDS.values():
        idx = make(x)
        for force in FORCES:
            idx.query(q, R, force=force)
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        idx.query(q, R)
    assert "hlsh.query" in opened


@pytest.mark.parametrize("metric", ["l2", "cosine"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_engine_counts_batches_and_blocking_copies(data, kind, metric):
    """2 syncs a hybrid batch with one routed group and 3 with two, 1 with
    a forced route, plus the hash's own (the p-stable divisor's copy on
    the plain path, which a CPU index takes: no hash on the kernel)."""
    x, q = data
    r = R
    if metric == "cosine":
        x = clustered_dataset(2048, 32, n_clusters=16, dense_core_frac=0.25,
                              core_scale=0.02, seed=0, metric="cosine")
        x, q = query_split(x, n_queries=40, seed=0)
        r = COSINE_R
    idx = KINDS[kind](x, metric=metric, r=r)
    h = idx.family.host_syncs
    assert h == (1 if metric == "l2" else 0)
    first = idx.query(q, r)
    assert len(first.lsh_idx) and len(first.lin_idx)   # both groups
    one = q[first.lsh_idx]                             # one group
    expect = {"batches": 1, "syncs": h + 3, "hash_kernel_batches": 0,
              "lsh_kernel_groups": 0}
    assert idx.index_stats()["query"] == expect
    for qs, force, syncs in ((q, None, 3), (one, None, 2), (q, "lsh", 1),
                             (q, "linear", 1)):
        res = idx.query(qs, r, force=force)
        if force is None:
            assert syncs == 1 + bool(len(res.lsh_idx)) + bool(
                len(res.lin_idx))
        expect = {"batches": expect["batches"] + 1,
                  "syncs": expect["syncs"] + h + syncs,
                  "hash_kernel_batches": 0, "lsh_kernel_groups": 0}
        assert idx.index_stats()["query"] == expect, (force, syncs)


def test_static_index_takes_the_tracer(data):
    x, q = data
    obs = Observability.create(enabled=True, trace_sample_every=1)
    traced, plain = _static(x, obs=obs), _static(x)
    for force in FORCES:
        assert _answers(traced.query(q, R, force=force)) == \
            _answers(plain.query(q, R, force=force))
    assert len(obs.tracer.spans()) == 3 * len(q)
    assert obs.tracer.summary()["batches_traced"] == 3
    assert traced.index_stats()["query"] == plain.index_stats()["query"]


@pytest.mark.parametrize("route", ["plain", "kernel"])
@pytest.mark.parametrize("nq,q_chunk,metric", [(33, 16, "l2"), (33, 32, "l1"),
                                               (65, 32, "l2"), (7, 0, "l1")])
def test_lsh_group_slices_only_on_the_plain_route(monkeypatch, route, nq,
                                                  q_chunk, metric):
    """``search.lsh_search`` verifies a group through
    ``ops.lsh_group_scan``: the plain version once a ``q_chunk`` slice, K2
    (here stood in by the plain chain over its whole input, behind
    ``ops.resolve_impl``) once for the group, with the same ids, mask and
    distances as the plain version unsliced.  The engine counts the LSH
    group in ``lsh_kernel_groups`` on K2's route only; ``batches`` counts
    on both."""
    from repro_torch.core import engine as engine_lib
    from repro_torch.core import search
    from repro_torch.core.lsh.tables import build_tables
    from repro_torch.kernels import fused_scan, ops
    from repro_torch.kernels import ref as kref
    rng = np.random.default_rng(nq)
    n, L, B, cap = 150, 4, 8, 3
    x = torch.from_numpy(rng.normal(size=(n, 6)).astype(np.float32))
    q = torch.from_numpy(rng.normal(size=(nq, 6)).astype(np.float32))
    tables = build_tables(torch.arange(n, dtype=torch.int32),
                          torch.from_numpy(rng.integers(0, B, (n, L))), B, 16)
    qb = torch.from_numpy(rng.integers(0, B, (nq, L)))
    r = 3.0 if metric == "l2" else 5.0
    want = search.lsh_search(x, tables, qb, q, r, metric, cap, q_chunk=0)
    calls = {"verify": 0, "kernel": 0}
    verify = ops.fused_lsh_scan_unsorted

    def counted(*a, **k):
        calls["verify"] += 1
        return verify(*a, **k)

    def stand_in(thresh, xk, qk, cands, *, metric):
        calls["kernel"] += 1
        ids = torch.sort(cands, dim=-1).values
        return kref.fused_lsh_scan(xk, ids, ops._run_prev(ids), qk, thresh,
                                   metric)

    monkeypatch.setattr(ops, "fused_lsh_scan_unsorted", counted)
    if route == "kernel":
        monkeypatch.setattr(ops, "resolve_impl", lambda impl, dev: "cuda")
        monkeypatch.setattr(fused_scan, "lsh_scan", stand_in)
        monkeypatch.setattr(ops, "route_estimate",
                            lambda qbk, t, tidx=None, impl=None:
                            kref.route_estimate(qbk, t, tidx))
    got = search.lsh_search(x, tables, qb, q, r, metric, cap, q_chunk=q_chunk)
    for a, b in zip(got, want):
        assert tuple(a.shape) == (nq, L * cap)
        assert torch.equal(a, b)
    sliced = -(-nq // q_chunk) if q_chunk else 1
    assert calls == ({"verify": sliced, "kernel": 0} if route == "plain"
                     else {"verify": 1, "kernel": 1})

    eng = engine_lib.QueryEngine(CostModel(alpha=1.0, beta=1.0))
    seg = engine_lib.TableSegment(tables=tables, x=x, metric=metric, cap=cap)
    for _ in range(2):
        eng.query([seg], q, qb, r, force="lsh")
    st = eng.stats()
    assert (st["batches"], st["lsh_kernel_groups"]) == (
        2, 2 * (route == "kernel"))
