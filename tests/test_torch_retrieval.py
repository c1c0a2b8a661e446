"""``repro_torch.serve.RetrievalService`` on the CPU.

  * the service tests of ``tests/test_serve.py`` (end to end, live
    mutation, exact linear stats, submit / drain against direct queries,
    the coalescing deadline, the stats schema and metrics), ported to the
    port's service on the port's own weights;
  * a differential against ``repro.serve.RetrievalService``: the same
    weights (the reference's ``init_params`` through
    ``interop.model_params_from_numpy``, float32 so that the embeddings
    agree to about 1e-7), the same SimHash draws (``index_params``), the
    same tokens; equal reported sets up to rows whose float64 distance
    lies within 1e-5 * max(1, r) of the radius r, equal ``stats`` keys
    and route counts, over inserts, deletes, compaction and the
    coalesced path;
  * ``tests/harness.py``'s ``MirrorOracle`` (one multi-tenant service
    against single-tenant mirrors) over the port's service in the sync,
    budgeted and async compaction modes;
  * a service checkpoint (default corpus and collections) written by the
    port and restored by the reference's service, and the reverse;
  * ``RetrievalConfig.mesh`` and a missing GPU raising.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from harness import MirrorOracle, decode_ops, quiesce  # noqa: E402
from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced_config  # noqa: E402
from repro.core.lsh import make_family as jmake_family  # noqa: E402
from repro.data import lm_batch as jlm_batch  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.models.parallel import ParallelConfig as JPar  # noqa: E402
from repro.serve import RetrievalConfig as JRConfig  # noqa: E402
from repro.serve import RetrievalService as JService  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.data import lm_batch  # noqa: E402
from repro_torch.interop import (model_params_from_numpy,  # noqa: E402
                                 params_from_numpy)
from repro_torch.models import ParallelConfig, init_params  # noqa: E402
from repro_torch.obs.schema import (CACHE_STATS_KEYS,  # noqa: E402
                                    DRIVER_STATS_KEYS, SCHEDULER_STATS_KEYS,
                                    WORK_PHASE_KEYS, retrieval_stats_keys)
from repro_torch.serve import (RetrievalConfig, RetrievalService,  # noqa: E402
                               TenantQuota)

PAR = ParallelConfig(mesh=None, attn_chunk_q=8, attn_chunk_k=8,
                     logits_chunk=8, remat="none")
JPAR = JPar(mesh=None, attn_chunk_q=8, attn_chunk_k=8, logits_chunk=8,
            remat="none")
SMALL = dict(radius=0.5, tables=8, num_buckets=256, hll_m=32, cap=64)
THRESH_EPS = 1e-5
NAMES = ("a", "b", "c")


def _cfg():
    return reduced_config(get_config("yi-6b"))


def _service(**kw):
    cfg = _cfg()
    params = init_params(cfg, seed=0, device="cpu")
    return cfg, RetrievalService(cfg, PAR, params,
                                 RetrievalConfig(**{**SMALL, **kw}),
                                 device="cpu")


def _batch(cfg, seed, step, b=32, s=12):
    out = lm_batch(seed, step, batch=b, seq=s, vocab=cfg.vocab, device="cpu")
    out.pop("labels")
    return out


# --------------------------------------------------------------------------
# the service tests of tests/test_serve.py
# --------------------------------------------------------------------------
def test_retrieval_service_end_to_end():
    cfg, svc = _service()
    corpus = [_batch(cfg, 3, i) for i in range(4)]
    n = svc.index_corpus(corpus)
    assert n == 128 and svc.index.n == 128

    res, emb = svc.query(_batch(cfg, 4, 0, b=16))
    assert emb.shape == (16, cfg.d_model) and emb.dtype == torch.float32
    # embeddings are L2-normalized (cosine metric contract)
    np.testing.assert_allclose(emb.norm(dim=1).numpy(), 1.0, rtol=1e-4)
    assert res.n_queries == 16
    assert svc.stats["queries"] == 16

    # a corpus document used as query must report itself (self-match)
    res2, _ = svc.query(corpus[0])
    found = sum(1 for i in range(32) if len(res2.neighbors(i)) > 0)
    assert found >= 28  # >= 1 - delta of self-matches at distance 0


def test_retrieval_service_live_mutation():
    """add/remove documents mutate the serving index without a rebuild."""
    cfg, svc = _service(delta_capacity=128)
    corpus = [_batch(cfg, 3, i) for i in range(2)]
    assert svc.index_corpus(corpus[:1]) == 32

    extra = corpus[1]
    new_ids = svc.add_documents([extra])
    assert len(new_ids) == 32 and svc.index.n == 64
    assert svc.stats["delta_live"] == 32          # no rebuild: delta holds them

    res, _ = svc.query(extra)
    found = sum(1 for i in range(32)
                if set(res.neighbors(i).tolist()) & set(new_ids.tolist()))
    assert found >= 28

    assert svc.remove_documents(new_ids.tolist()) == 32
    assert svc.index.n == 32
    res2, _ = svc.query(extra)
    reported = set().union(*(set(res2.neighbors(i).tolist())
                             for i in range(32)))
    assert reported.isdisjoint(set(new_ids.tolist()))
    assert "compactions" in svc.stats


def test_retrieval_service_exact_linear_stats():
    """stats accumulate the exact per-query linear count from the route
    partition, not the rounded frac_linear reconstruction."""
    cfg, svc = _service()
    svc.index_corpus([_batch(cfg, 3, 0)])
    qb = _batch(cfg, 4, 0, b=16)
    total = 0
    for _ in range(3):
        res, _ = svc.query(qb)
        exact = len(set(np.asarray(res.lin_idx).tolist()))
        assert res.n_linear == exact
        total += exact
    assert svc.stats["linear_served"] == total
    assert svc.stats["queries"] == 48


def test_submit_drain_matches_direct_query():
    """The coalesced path reports exactly what per-request query() does:
    multi-row requests are scattered back intact, and resubmits in an
    unchanged index state are served from the cache bit-identically."""
    cfg, svc = _service()
    svc.index_corpus([_batch(cfg, 3, 0)])
    toks = _batch(cfg, 4, 0, b=6)["tokens"].numpy()

    # requests of 1, 2, and 3 query rows coalesce into one batch; a
    # tensor is taken like an array
    u1 = svc.submit(toks[0])                       # 1-D row: one query
    u2 = svc.submit({"tokens": torch.from_numpy(toks[1:3])})
    u3 = svc.submit(toks[3:6])
    out = svc.drain_batches()
    assert set(out) == {u1, u2, u3}
    assert [out[u].n_queries for u in (u1, u2, u3)] == [1, 2, 3]
    assert not any(out[u].cached for u in (u1, u2, u3))

    direct, _ = svc.query({"tokens": toks})
    flat_ids = [out[u].ids[j] for u in (u1, u2, u3)
                for j in range(out[u].n_queries)]
    flat_d = [out[u].dists[j] for u in (u1, u2, u3)
              for j in range(out[u].n_queries)]
    for i in range(6):
        ids_d, dists_d = direct.reported(i)
        np.testing.assert_array_equal(flat_ids[i], np.asarray(ids_d))
        np.testing.assert_array_equal(flat_d[i], np.asarray(dists_d))

    # same state, same queries -> pure cache hits, same bits
    u4 = svc.submit({"tokens": toks[1:3]})
    out2 = svc.drain_batches()
    assert out2[u4].cached
    for j in range(2):
        np.testing.assert_array_equal(out2[u4].ids[j], out[u2].ids[j])
        np.testing.assert_array_equal(out2[u4].dists[j], out[u2].dists[j])
    assert svc.stats["cache"]["hits"] == 1
    assert svc.stats["queries"] == 6 + 6           # drain + direct


def test_drain_respects_deadline_until_forced():
    cfg, svc = _service(coalesce_max_wait_s=3600.0)
    b = _batch(cfg, 3, 0)
    svc.index_corpus([b])
    u = svc.submit(b["tokens"][0])
    assert svc.drain_batches() == {}               # held for coalescing
    assert svc.stats["scheduler"]["queue_depth"] == 1
    out = svc.drain_batches(force=True)
    assert set(out) == {u} and not out[u].cached


def test_retrieval_service_stats_schema_and_metrics(tmp_path):
    """stats keys match the documented schema exactly; metrics() is one
    JSON round-trippable snapshot; shutdown dumps it to disk."""
    cfg, svc = _service(delta_capacity=128, async_compaction=True,
                        obs_trace_sample_every=1)
    svc.index_corpus([_batch(cfg, 3, i) for i in range(2)])
    st = svc.stats
    assert set(st) == retrieval_stats_keys(driver=True)
    assert set(st["work_seconds"]) == WORK_PHASE_KEYS
    assert set(st["driver"]) == DRIVER_STATS_KEYS
    assert set(st["scheduler"]) == SCHEDULER_STATS_KEYS
    assert set(st["cache"]) == CACHE_STATS_KEYS

    svc.query(_batch(cfg, 4, 0, b=8))
    m = svc.metrics()
    m2 = json.loads(json.dumps(m))      # round-trip
    assert set(m2) == {"registry", "tracing", "events", "stats"}
    assert m2["registry"]["counters"]["repro_service_queries_total"] == 8
    assert m2["tracing"]["queries"] == 8
    assert m2["stats"]["queries"] == 8
    assert "repro_service_queries_total 8" in svc.metrics_text()

    dump = tmp_path / "metrics.json"
    svc.shutdown(dump_path=str(dump))
    assert not svc.stats["driver"]["worker_alive"]
    assert json.loads(dump.read_text())["stats"]["queries"] == 8
    svc.shutdown()                       # idempotent


def test_mesh_and_missing_gpu_raise():
    """A mesh must be a ``ShardMesh`` (the sharded service itself is
    held in ``tests/test_torch_sharded.py``); without a GPU the default
    service and the default mesh raise."""
    from repro_torch.core.distributed import make_mesh
    cfg = _cfg()
    params = init_params(cfg, device="cpu")
    with pytest.raises(TypeError, match="ShardMesh"):
        RetrievalService(cfg, PAR, params, RetrievalConfig(mesh=object()),
                         device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is there")
    with pytest.raises(RuntimeError, match="CUDA"):
        RetrievalService(cfg, PAR, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(2)


# --------------------------------------------------------------------------
# differential against repro.serve.RetrievalService
# --------------------------------------------------------------------------
def _pair(**kw):
    """(reference service, port service, port cfg): float32 reduced yi-6b
    with the reference's weights in both, the port's indexes on the
    reference's SimHash draws."""
    jc = dataclasses.replace(jreduced_config(jget_config("yi-6b")),
                             dtype="float32")
    tc = dataclasses.replace(_cfg(), dtype="float32")
    jp = jinit_params(jc, jax.random.PRNGKey(0))
    tp = model_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), tc, "cpu")
    rkw = {**SMALL, **kw}
    jsvc = JService(jc, JPAR, jp, JRConfig(**rkw))
    # the reference's draws: every index it builds uses key 0
    fam = jmake_family("cosine", d=jc.d_model, L=rkw["tables"],
                       r=rkw["radius"], delta=0.1)
    draws = params_from_numpy(
        {k: np.asarray(v)
         for k, v in fam.init(jax.random.PRNGKey(0)).items()}, "cpu")
    tsvc = RetrievalService(tc, PAR, tp, RetrievalConfig(**rkw),
                            index_params=draws, device="cpu")
    return jsvc, tsvc, jc


def _jbatch(cfg, seed, step, b=32, s=12):
    out = jlm_batch(seed, step, batch=b, seq=s, vocab=cfg.vocab, cfg=cfg)
    return {"tokens": np.array(out["tokens"])}


def _assert_sets_match(a, b, q, rows, r, what):
    """Reported sets equal up to rows within THRESH_EPS * max(1, r) of r
    (float64 cosine distance of the embeddings)."""
    for i in range(len(q)):
        diff = set(a[i]) ^ set(b[i])
        for j in diff:
            x = rows[j].astype(np.float64)
            d = 1.0 - float(q[i].astype(np.float64) @ x) / max(
                np.linalg.norm(q[i]) * np.linalg.norm(x), 1e-12)
            assert abs(d - r) <= THRESH_EPS * max(1.0, r), \
                (what, i, j, d, r)


def _sets(res):
    return {i: set(res.neighbors(i).tolist()) for i in range(res.n_queries)}


@pytest.mark.parametrize("mode,beta_over_alpha", [("sync", 1.0),
                                                   ("budgeted", 10.0)])
def test_differential_against_the_reference_service(mode, beta_over_alpha):
    """beta/alpha 1 mixes the routes in every batch here; 10 sends every
    query to LSH."""
    kw = dict(delta_capacity=64, beta_over_alpha=beta_over_alpha)
    if mode == "budgeted":
        kw["compact_step_rows"] = 32
    jsvc, tsvc, jc = _pair(**kw)
    corpus = [_jbatch(jc, 3, i) for i in range(4)]
    rows = {}

    def note(ids, batches):
        emb = np.concatenate([tsvc.embed(b).numpy() for b in batches])
        rows.update(zip(np.asarray(ids).tolist(), emb))

    assert jsvc.index_corpus(corpus) == tsvc.index_corpus(corpus) == 128
    note(range(128), corpus)
    extra = [_jbatch(jc, 5, i) for i in range(3)]
    a_ids = jsvc.add_documents(extra)
    np.testing.assert_array_equal(a_ids, tsvc.add_documents(extra))
    note(a_ids, extra)
    gone = list(range(0, 128, 5)) + a_ids[::7].tolist()
    assert jsvc.remove_documents(gone) == tsvc.remove_documents(gone)
    quiesce(jsvc)
    quiesce(tsvc)

    for step in range(3):
        qb = _jbatch(jc, 4, step, b=16)
        qb["tokens"][:4] = corpus[step]["tokens"][:4]    # self matches
        jres, jemb = jsvc.query(qb)
        tres, temb = tsvc.query(qb)
        np.testing.assert_allclose(temb.numpy(), np.asarray(jemb),
                                   rtol=1e-5, atol=1e-5)
        assert tres.n_linear == jres.n_linear
        if beta_over_alpha == 1.0:
            assert 0 < tres.n_linear < 16, tres.n_linear
        # the reference pads its route groups with repeats of the last
        np.testing.assert_array_equal(tres.lin_idx,
                                      np.unique(np.asarray(jres.lin_idx)))
        ts = _sets(tres)
        assert all(not (s & set(gone)) for s in ts.values())
        assert sum(len(s) for s in ts.values()) > 0
        _assert_sets_match(ts, _sets(jres), temb.numpy(), rows,
                           SMALL["radius"], f"{mode} step {step}")
        for force in ("lsh", "linear"):
            _assert_sets_match(
                _sets(tsvc.index.query(temb, SMALL["radius"], force=force)),
                _sets(jsvc.index.query(jnp.asarray(temb.numpy()),
                                       SMALL["radius"], force=force)),
                temb.numpy(), rows, SMALL["radius"], f"{mode} {force}")

    # the coalesced path: same uids, same sets, same cache behaviour
    toks = _jbatch(jc, 6, 0, b=7)["tokens"]
    for svc in (jsvc, tsvc):
        svc.submit(toks[0])
        svc.submit({"tokens": toks[1:4]})
        svc.submit(toks[4:7])
        svc.submit(toks[1:4])
    jout, tout = jsvc.drain_batches(force=True), tsvc.drain_batches(force=True)
    assert sorted(jout) == sorted(tout)
    for u in tout:
        assert tout[u].cached == jout[u].cached
        assert tout[u].n_queries == jout[u].n_queries
    flat = [set(x.tolist()) for u in sorted(tout) for x in tout[u].ids]
    jflat = [set(np.asarray(x).tolist())
             for u in sorted(jout) for x in jout[u].ids]
    emb = tsvc.embed({"tokens": toks}).numpy()
    qrows = np.concatenate([emb[:1], emb[1:4], emb[4:7], emb[1:4]])
    _assert_sets_match(dict(enumerate(flat)), dict(enumerate(jflat)),
                       qrows, rows, SMALL["radius"], f"{mode} drain")

    js, ts = jsvc.stats, tsvc.stats
    assert set(ts) == set(js)
    for key in ("queries", "linear_served", "index_size", "n_live",
                "n_main", "n_main_dead", "delta_count", "delta_live",
                "segments", "inserts", "deletes", "compaction_ticks",
                "idle_ticks", "freezes"):
        assert ts[key] == js[key], key
    assert ts["cache"] == js["cache"]
    assert set(ts["scheduler"]) == set(js["scheduler"])
    for svc in (jsvc, tsvc):
        svc.shutdown()


# --------------------------------------------------------------------------
# tests/harness.py's MirrorOracle over the port's service
# --------------------------------------------------------------------------
_RAW_STREAM = [0, 1, 2, 7, 13, 19, 45, 91, 121, 57, 38, 103, 5, 64,
               20, 33, 75, 9, 111, 58]


@pytest.mark.parametrize("mode", ["sync", "budgeted", "async"])
def test_mirror_oracle_isolation_under_churn(mode):
    """One multi-tenant service and three single-tenant mirrors replay
    one op stream; per-collection reported sets stay bit-identical under
    interleaved add / remove / compaction churn, and the coalesced
    submit path agrees too."""
    cfg = _cfg()
    params = init_params(cfg, seed=0, device="cpu")
    kw = dict(SMALL, delta_capacity=64)
    if mode == "budgeted":
        kw["compact_step_rows"] = 32
    elif mode == "async":
        kw.update(async_compaction=True, compact_step_rows=32)

    def make():
        return RetrievalService(cfg, PAR, params, RetrievalConfig(**kw),
                                device="cpu")

    def insert_fn(name, arg):
        return _batch(cfg, 100 + NAMES.index(name), arg % 7, b=16)

    def query_fn(arg):
        return _batch(cfg, 4, arg % 3, b=4)

    oracle = MirrorOracle(make, NAMES, insert_fn, query_fn)
    try:
        ops = decode_ops(_RAW_STREAM, names=NAMES)
        assert {k for k, _, _ in ops} >= {"create", "insert", "query"}
        oracle.run(ops)
        oracle.check_submit_round()
        assert oracle.queries_checked > 0
    finally:
        oracle.close()


# --------------------------------------------------------------------------
# service checkpoints across the packages
# --------------------------------------------------------------------------
def _churned(svc, cfg, jax_tokens):
    """Default corpus + two collections (one with a quota), churned."""
    b = (_jbatch if jax_tokens else _batch)
    svc.index_corpus([b(cfg, 3, i) for i in range(2)])
    svc.add_documents([b(cfg, 5, 0)])
    svc.remove_documents(list(range(0, 64, 3)))
    svc.create_collection("a", [b(cfg, 7, 0)],
                          quota=TenantQuota(rate=5.0, burst=3, weight=2.0))
    svc.create_collection("b")
    svc.add_documents([b(cfg, 8, 0)], collection="b")
    svc.remove_documents([1, 2], collection="b")


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_service_checkpoint_crosses_packages(tmp_path, writer):
    jsvc, tsvc, jc = _pair(delta_capacity=64)
    src, dst = (tsvc, jsvc) if writer == "port" else (jsvc, tsvc)
    _churned(src, jc, jax_tokens=True)
    mgr = (CheckpointManager if writer == "port" else JManager)(
        str(tmp_path))
    src.checkpoint(mgr, 1)
    reader = (JManager if writer == "port" else CheckpointManager)(
        str(tmp_path))
    assert reader.collection_names(1) == ["a", "b"]
    assert dst.restore(reader) == 1
    assert dst.collections.names() == ["a", "b"]
    assert (dataclasses.astuple(dst.collections.get("a").quota)
            == dataclasses.astuple(src.collections.get("a").quota))
    q = tsvc.embed(_jbatch(jc, 4, 0, b=16)).numpy()
    for col in ("", "a", "b"):
        a, b = src._index_for(col), dst._index_for(col)
        assert a.n == b.n, col
        assert a.state_digests() == b.state_digests(), col
        for force in ("lsh", "linear"):
            qa = q if writer == "port" else jnp.asarray(q)
            qb = jnp.asarray(q) if writer == "port" else q
            assert (_sets(a.query(qa, SMALL["radius"], force=force))
                    == _sets(b.query(qb, SMALL["radius"], force=force))), \
                (writer, col, force)
    for svc in (jsvc, tsvc):
        svc.shutdown()
