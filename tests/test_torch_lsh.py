"""Parity of ``repro_torch.core.lsh`` (families + CSR tables) with
``repro.core.lsh`` on the CPU, given the reference's random draws."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.lsh import families as jfam  # noqa: E402
from repro.core.lsh import tables as jtab  # noqa: E402
from repro_torch.core.lsh import families as tfam  # noqa: E402
from repro_torch.core.lsh import tables as ttab  # noqa: E402
from repro_torch.interop import params_from_numpy, tables_from_numpy  # noqa: E402

RNG = np.random.default_rng(0)
N, D, L = 2048, 64, 8


def _port_family(fam):
    cls = getattr(tfam, type(fam).__name__)
    return cls(**{f: getattr(fam, f) for f in fam.__dataclass_fields__})


def _case(metric):
    """(reference family, its params, input rows, float64 boundary
    distance of every code or None)."""
    if metric == "hamming":
        fam = jfam.make_family("hamming", d=64, L=L, r=6.0)
        x = RNG.integers(0, 2**32, (N, 2), dtype=np.uint32)
    else:
        fam = jfam.make_family(metric, d=D, L=L, r=0.7)
        x = (2.0 * RNG.normal(size=(N, D))).astype(np.float32)
    params = {k: np.asarray(v) for k, v in
              fam.init(jax.random.PRNGKey(1)).items()}
    margin = None
    if metric == "cosine":
        margin = np.abs(x.astype(np.float64) @ params["R"])
    elif metric in ("l2", "l1"):
        proj = (x.astype(np.float64) @ params["a"] + params["b"]) / fam.w
        margin = np.abs(proj - np.round(proj))
    return fam, params, x, margin


def _rows(x):
    return torch.from_numpy(x.astype(np.int64) if x.dtype == np.uint32 else x)


@pytest.mark.parametrize("metric", ["cosine", "l2", "l1", "hamming"])
def test_family_codes_and_buckets_match(metric):
    """Codes and bucket ids are bit-identical, except where a float
    product lies within 1e-6 of a sign or floor boundary; there the
    agreement rate is stated and must be >= 99.9 %."""
    fam, params, x, margin = _case(metric)
    port = _port_family(fam)
    tp = params_from_numpy(params, "cpu")
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    want_c = np.asarray(fam.codes(jp, jnp.asarray(x))).astype(np.int64)
    got_c = port.codes(tp, _rows(x)).numpy()
    want_b = np.asarray(fam.bucket_ids(jp, jnp.asarray(x), 1024))
    got_b = port.bucket_ids(tp, _rows(x), 1024).numpy()
    assert got_c.shape == want_c.shape and got_b.shape == want_b.shape
    if margin is None:
        near = np.zeros(N, bool)
    else:
        near = (margin < 1e-6).reshape(N, -1).any(axis=1)
    np.testing.assert_array_equal(got_c[~near], want_c[~near])
    np.testing.assert_array_equal(got_b[~near], want_b[~near])
    agree = float((got_b == want_b).all(axis=1).mean())
    print(f"{metric}: {near.sum()} rows near a boundary, "
          f"bucket-id agreement {agree:.6f}")
    assert agree >= 0.999
    if metric in ("l2", "l1"):           # negative floors wrap to uint32
        assert (want_c >= 2**31).any()


def test_bucket_fn_for_is_bucket_ids():
    fam, params, x, _ = _case("cosine")
    port = _port_family(fam)
    tp = params_from_numpy(params, "cpu")
    fn = tfam.bucket_fn_for(port, 512)
    np.testing.assert_array_equal(fn(tp, _rows(x)).numpy(),
                                  port.bucket_ids(tp, _rows(x), 512).numpy())


@pytest.mark.parametrize("metric,kw", [
    ("cosine", {}), ("hamming", {}), ("l2", {}), ("l1", {}),
    ("cosine", {"k": 5}), ("l2", {"k": 3, "w": 1.5})])
def test_make_family_matches(metric, kw):
    a = jfam.make_family(metric, d=32, L=6, r=0.4, **kw)
    b = tfam.make_family(metric, d=32, L=6, r=0.4, **kw)
    assert type(a).__name__ == type(b).__name__
    assert dataclasses_dict(a) == dataclasses_dict(b)
    assert a.p1_code(0.4) == b.p1_code(0.4)
    assert tfam.k_from_delta(0.8, 20, 0.1) == jfam.k_from_delta(0.8, 20, 0.1)


def dataclasses_dict(obj):
    return {f: getattr(obj, f) for f in obj.__dataclass_fields__}


@pytest.mark.parametrize("metric", ["cosine", "l2", "l1", "hamming"])
def test_init_draws_on_device_with_generator(metric):
    fam = tfam.make_family(metric, d=16, L=3, r=0.5)
    a = fam.init(torch.Generator().manual_seed(3), device="cpu")
    b = fam.init(torch.Generator().manual_seed(3), device="cpu")
    for k in a:
        assert torch.equal(a[k], b[k])
    if metric == "hamming":
        assert int(a["pos"].min()) >= 0 and int(a["pos"].max()) < 16


# ---------------------------------------------------------------------------
# CSR tables
# ---------------------------------------------------------------------------
def _tables(n, L, B, m):
    """Tables from both packages on the same bucket ids.  Few buckets
    make equal-key runs far longer than any cap."""
    ids = np.arange(n, dtype=np.int32)
    bids = RNG.integers(0, B, size=(n, L)).astype(np.int32)
    ref = jtab.build_tables(jnp.asarray(ids), jnp.asarray(bids), B, m)
    port = ttab.build_tables(torch.from_numpy(ids), torch.from_numpy(bids),
                             B, m)
    return ref, port


@pytest.mark.parametrize("n,L,B,m", [(2048, 8, 4, 64), (1000, 3, 64, 16),
                                     (777, 5, 1024, 32)])
def test_build_tables_bit_identical(n, L, B, m):
    ref, port = _tables(n, L, B, m)
    np.testing.assert_array_equal(port.perm.numpy(), np.asarray(ref.perm))
    np.testing.assert_array_equal(port.starts.numpy(), np.asarray(ref.starts))
    np.testing.assert_array_equal(port.registers.numpy(),
                                  np.asarray(ref.registers))
    assert port.perm.dtype == torch.int32 and port.registers.dtype == torch.uint8
    assert (port.L, port.n, port.num_buckets, port.m) == (L, n, B, m)


def test_stable_sort_decides_the_cap_cut():
    """Runs of ~512 equal bucket ids: only a stable sort keeps the ids
    that the reference keeps under cap = 16."""
    ref, port = _tables(2048, 8, 4, 64)
    counts = np.diff(np.asarray(ref.starts), axis=1)
    assert counts.max() > 16
    qb = RNG.integers(0, 4, size=(10, 8)).astype(np.int32)
    want = np.asarray(jtab.gather_candidates(ref, jnp.asarray(qb), 16, 2048))
    got = ttab.gather_candidates(port, torch.from_numpy(qb), 16, 2048)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("use_tidx", [False, True])
@pytest.mark.parametrize("cap", [2, 16, 64])
def test_gathers_bit_identical(use_tidx, cap):
    n, L, B, m = 600, 4, 32, 16
    ref, port = _tables(n, L, B, m)
    V = 2 * L if use_tidx else L
    qb = RNG.integers(0, B, size=(9, V)).astype(np.int32)
    tidx = np.repeat(np.arange(L), 2).astype(np.int32) if use_tidx else None
    jt = None if tidx is None else jnp.asarray(tidx)
    tt = None if tidx is None else torch.from_numpy(tidx)
    jq, tq = jnp.asarray(qb), torch.from_numpy(qb)
    np.testing.assert_array_equal(
        ttab.bucket_counts(port, tq, tidx=tt).numpy(),
        np.asarray(jtab.bucket_counts(ref, jq, tidx=jt)))
    np.testing.assert_array_equal(
        ttab.gather_registers(port, tq, tidx=tt).numpy(),
        np.asarray(jtab.gather_registers(ref, jq, tidx=jt)))
    np.testing.assert_array_equal(
        ttab.gather_candidates(port, tq, cap, n, tidx=tt).numpy(),
        np.asarray(jtab.gather_candidates(ref, jq, cap, n, tidx=jt)))
    np.testing.assert_array_equal(
        ttab.table_index(port, tt).numpy(),
        np.asarray(jtab.table_index(ref, jt)))


def test_tables_from_numpy_round_trip():
    ref, _ = _tables(300, 3, 16, 32)
    port = tables_from_numpy(np.asarray(ref.perm), np.asarray(ref.starts),
                             np.asarray(ref.registers), "cpu")
    assert port.perm.dtype == torch.int32
    assert port.starts.dtype == torch.int32
    assert port.registers.dtype == torch.uint8
    np.testing.assert_array_equal(port.registers.numpy(),
                                  np.asarray(ref.registers))
