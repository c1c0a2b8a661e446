"""End-to-end parity of ``repro_torch``'s static ``HybridLSHIndex`` with
``repro``'s on the CPU, plus the port's ground rules (no JAX, no CPU
default)."""
import ast
import pathlib

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core.lsh import make_family as jmake_family  # noqa: E402
from repro.data import clustered_dataset as jclustered  # noqa: E402
from repro.data import query_split as jsplit  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.core.lsh import make_family  # noqa: E402
from repro_torch.data import clustered_dataset, paper_dataset, query_split  # noqa: E402
from repro_torch.interop import params_from_numpy, tables_from_numpy  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
REL = 1e-5          # rows this close (relative) to the threshold may flip

# metric -> radius; with beta/alpha = 1 (the paper's MNIST preset) the
# dense-core queries go linear and the rest LSH at these radii
CASES = {"l2": 0.45, "cosine": 0.05, "l1": 3.0, "hamming": 20.0}


def _data(metric):
    if metric == "hamming":
        words, _ = paper_dataset("mnist", scale=0.034, seed=0)   # n=2040
        words, queries = query_split(words, n_queries=40, seed=0)
        return words, queries
    x = clustered_dataset(2048, 32, n_clusters=16, dense_core_frac=0.25,
                          core_scale=0.02, seed=0, metric=metric)
    return query_split(x, n_queries=40, seed=0)


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


def _assert_sets_equal(a, b, x, queries, metric, r):
    """Equal neighbor sets, except ids within REL of the threshold."""
    t = r * r if metric == "l2" else r
    for i in a:
        diff = np.array(sorted(a[i] ^ b[i]), np.int64)
        if len(diff):
            d = _dist64(metric, queries[i], x[diff])
            assert np.all(np.abs(d - t) <= REL * abs(t)), (i, diff, d, t)


def _pair(metric):
    """A repro index and a port index sharing its params and tables."""
    x, queries = _data(metric)
    d = x.shape[1] * (32 if metric == "hamming" else 1)
    r = CASES[metric]
    cm = jcore.CostModel(alpha=1.0, beta=1.0)
    ref = jcore.HybridLSHIndex(jmake_family(metric, d=d, L=8, r=r),
                               num_buckets=256, m=64, cap=64, cost_model=cm,
                               key=0)
    ref.build(jnp.asarray(x))
    fam = make_family(metric, d=d, L=8, r=r)
    port = tcore.HybridLSHIndex(
        fam, num_buckets=256, m=64, cap=64,
        cost_model=tcore.CostModel(alpha=1.0, beta=1.0),
        params=params_from_numpy({k: np.asarray(v)
                                  for k, v in ref.params.items()}, "cpu"),
        device="cpu")
    return ref, port, x, queries, r


@pytest.mark.parametrize("metric", ["l2", "cosine", "l1", "hamming"])
def test_index_with_reference_tables(metric):
    """(i) The port gets repro's params and tables: routes and neighbor
    sets agree for force None / "lsh" / "linear"."""
    ref, port, x, queries, r = _pair(metric)
    port.x = torch.from_numpy(
        x.view(np.int32) if metric == "hamming" else x)
    port.tables = tables_from_numpy(np.asarray(ref.tables.perm),
                                    np.asarray(ref.tables.starts),
                                    np.asarray(ref.tables.registers), "cpu")
    je = ref.estimate(jnp.asarray(queries))
    te = port.estimate(queries)
    np.testing.assert_array_equal(te.collisions.numpy(),
                                  np.asarray(je.collisions))
    np.testing.assert_allclose(te.cand_est.numpy(), np.asarray(je.cand_est),
                               rtol=1e-5)
    lin = float(je.linear_cost)
    assert float(te.linear_cost) == lin
    differ = te.use_lsh.numpy() != np.asarray(je.use_lsh)
    close = np.abs(np.asarray(je.lsh_cost) - lin) <= 1e-5 * lin
    assert not (differ & ~close).any()
    use = np.asarray(je.use_lsh)
    print(f"{metric}: {use.sum()} of {len(use)} queries routed to LSH, "
          f"{differ.sum()} routes differ within 1e-5 of the cost tie")
    for force in (None, "lsh", "linear"):
        a = port.query(queries, r, force=force)
        b = ref.query(jnp.asarray(queries), r, force=force)
        _assert_sets_equal(a.neighbor_sets(), b.neighbor_sets(), x, queries,
                           metric, r)
        if force is None and not differ.any():
            # repro pads each group to a power of two; the port does not
            np.testing.assert_array_equal(a.lsh_idx, np.unique(b.lsh_idx))
            np.testing.assert_array_equal(a.lin_idx, np.unique(b.lin_idx))
            assert a.n_linear == b.n_linear
            assert a.frac_linear == b.frac_linear
    if metric != "l1":
        assert 0 < use.sum() < len(use), "both routes should win queries"


@pytest.mark.parametrize("metric", ["l2", "cosine", "l1", "hamming"])
def test_index_builds_its_own_tables(metric):
    """(ii) The port hashes and builds from the same params: bucket-id
    agreement >= 99.9 %, and equal neighbor sets for every query whose
    buckets agree."""
    ref, port, x, queries, r = _pair(metric)
    port.build(x)
    want_b = np.asarray(ref._bucket_fn(ref.params, jnp.asarray(x)))
    got_b = port.bucket_ids(port.x).numpy()
    agree = float((want_b == got_b).all(axis=1).mean())
    print(f"{metric}: corpus bucket-id agreement {agree:.6f}")
    assert agree >= 0.999
    if agree == 1.0:
        np.testing.assert_array_equal(port.tables.perm.numpy(),
                                      np.asarray(ref.tables.perm))
        np.testing.assert_array_equal(port.tables.registers.numpy(),
                                      np.asarray(ref.tables.registers))
    qw = np.asarray(ref._bucket_fn(ref.params, jnp.asarray(queries)))
    qg = port.bucket_ids(torch.from_numpy(
        queries.view(np.int32) if metric == "hamming" else queries)).numpy()
    same = (qw == qg).all(axis=1)
    print(f"{metric}: query bucket-id agreement {same.mean():.6f}")
    for force in (None, "lsh", "linear"):
        a = port.query(queries, r, force=force).neighbor_sets()
        b = ref.query(jnp.asarray(queries), r, force=force).neighbor_sets()
        keep = [i for i in a if same[i]]
        _assert_sets_equal({i: a[i] for i in keep}, {i: b[i] for i in keep},
                           x, queries, metric, r)


def test_query_result_accessors_and_memory_stats():
    ref, port, x, queries, r = _pair("l2")
    assert port.memory_stats()["perm_bytes"] == 0
    port.build(x)
    ref_stats = ref.memory_stats()
    assert port.memory_stats() == ref_stats
    res = port.query(queries, r)
    ids, dists = res.reported(0)
    assert set(ids.tolist()) == set(res.neighbors(0).tolist())
    assert np.all(dists <= r * r + 1e-6)
    assert res.n_queries == len(queries)
    assert 0.0 <= res.frac_linear <= 1.0
    with pytest.raises(KeyError):
        res.neighbors(len(queries))


@pytest.mark.parametrize("n_segments", [1, 3])
def test_finalize_route_matches_repro(n_segments):
    """Collisions and HLL registers of one or several segments combine
    as in repro, candSize clamped by the live rows.  The port's segments
    hand ``finalize_route`` their HLL estimates (``cand_est``, as
    ``ops.route_estimate`` does), repro's their registers."""
    rng = np.random.default_rng(3 + n_segments)
    q, L, m = 12, 4, 32
    parts = [(rng.integers(0, 400, q).astype(np.int32),
              rng.integers(0, 8, (q, L, m)).astype(np.uint8), n_live)
             for n_live in (300, 200, 7)[:n_segments]]

    cm = jcore.CostModel(alpha=1.0, beta=6.0)
    je = jengine.finalize_route(
        [jengine.SegmentEstimate(collisions=jnp.asarray(c),
                                 registers=jnp.asarray(g), n_live=n,
                                 n_scan=n + 5) for c, g, n in parts], cm)
    te = tengine.finalize_route(
        [tengine.SegmentEstimate(
            collisions=torch.from_numpy(c),
            cand_est=tops.hll_merge_estimate(torch.from_numpy(g)),
            n_live=n, n_scan=n + 5) for c, g, n in parts],
        tcore.CostModel(alpha=1.0, beta=6.0))
    np.testing.assert_array_equal(te.collisions.numpy(),
                                  np.asarray(je.collisions))
    np.testing.assert_allclose(te.cand_est.numpy(), np.asarray(je.cand_est),
                               rtol=1e-5)
    np.testing.assert_allclose(te.lsh_cost.numpy(), np.asarray(je.lsh_cost),
                               rtol=1e-5)
    np.testing.assert_array_equal(te.use_lsh.numpy(), np.asarray(je.use_lsh))
    assert te.linear_cost == je.linear_cost
    assert float(te.cand_est.max()) <= sum(n for _, _, n in parts)


@pytest.mark.parametrize("pattern", ["mixed", "all_lsh", "all_linear"])
def test_partition_matches_repro(pattern):
    """The port's unpadded groups are repro's power-of-two padded groups
    without the repeated tail."""
    use = {"mixed": np.array([1, 0, 0, 1, 1, 0, 1, 1, 1, 0, 1], bool),
           "all_lsh": np.ones(13, bool),
           "all_linear": np.zeros(9, bool)}[pattern]
    for a, b in zip(tengine.partition_indices(use),
                    jengine.partition_indices(use)):
        np.testing.assert_array_equal(a, np.unique(np.asarray(b)))
    lsh_idx, lin_idx = tengine.partition_indices(use)
    assert len(lsh_idx) + len(lin_idx) == len(use)
    np.testing.assert_array_equal(np.sort(np.concatenate([lsh_idx, lin_idx])),
                                  np.arange(len(use)))


def test_datasets_are_the_references():
    from repro.data import paper_dataset as jpaper
    a = clustered_dataset(500, 8, dense_core_frac=0.2, seed=4)
    np.testing.assert_array_equal(a, jclustered(500, 8, dense_core_frac=0.2,
                                                seed=4))
    for name in ("corel", "mnist"):
        x, metric = paper_dataset(name, scale=0.02, seed=1)
        y, jmetric = jpaper(name, scale=0.02, seed=1)
        assert metric == jmetric
        np.testing.assert_array_equal(x, y)
        for u, v in zip(query_split(x, 30, seed=2), jsplit(y, 30, seed=2)):
            np.testing.assert_array_equal(u, v)


def test_default_device_is_cuda_and_never_cpu():
    fam = make_family("l2", d=8, L=2, r=0.5)
    if torch.cuda.is_available():
        assert tcore.HybridLSHIndex(fam, num_buckets=16).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tcore.HybridLSHIndex(fam, num_buckets=16)
        with pytest.raises(RuntimeError, match="CUDA"):
            tcore.HybridLSHIndex(fam, num_buckets=16, device="cuda")
    idx = tcore.HybridLSHIndex(fam, num_buckets=16, device="cpu",
                               seed=torch.Generator().manual_seed(1))
    assert idx.params["a"].device.type == "cpu"


def _port_files():
    """Every module of the package (its launchers included), the chip
    smoke script and the port's example."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "examples" / "quickstart_torch.py"]
    return files


def test_port_imports_no_jax_and_no_repro():
    files = _port_files()
    for part in ("launch/serve.py", "serve/retrieval.py", "serve/engine.py",
                 "models/transformer.py", "configs/base.py",
                 "core/distributed.py", "streaming/sharded.py"):
        assert ROOT / "src" / "repro_torch" / part in files, part
    bad = []
    for path in files:
        assert path.exists(), path
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "repro", "ml_dtypes"):
                    bad.append(f"{path.relative_to(ROOT)}:{node.lineno} {name}")
    assert not bad, bad
