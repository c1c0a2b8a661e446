"""The port's kernel functions against ``repro.kernels``.

On the CPU the port's ``ops`` run the plain versions; they are held
against ``repro.kernels.ops`` under both ``impl="pallas_interpret"``
(the Pallas kernels in interpret mode) and ``impl="ref"`` (the composed
jnp oracles), on the cases of ``tests/test_kernels.py``.  Ids and masks
are exact; distances are allclose at rtol = atol = 3e-4 (the repo's own
kernel tolerance: the two sides reduce in different orders), and the
LSH scan's distances are compared only under the mask.

The CUDA kernels are held against the plain versions on a card by
``test_torch_gpu.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import search as tsearch  # noqa: E402
from repro_torch.core.lsh.tables import build_tables  # noqa: E402
from repro_torch.kernels import hll_merge  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from torch_cases import (RADII, TOL, as_tensor, handcrafted_ids,  # noqa: E402
                         hll_regs, lsh_ids, pair)

RNG = np.random.default_rng(0)
JAX_IMPLS = ["pallas_interpret", "ref"]


_t = as_tensor


def _pair(metric, q, n):
    return pair(metric, q, n, RNG)


def _j(a):
    return jnp.asarray(a)


# ---------------------------------------------------------------------------
# Plain versions (CPU) vs repro
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("jimpl", JAX_IMPLS)
@pytest.mark.parametrize("metric", ["l2", "l1", "cosine", "hamming"])
@pytest.mark.parametrize("q,n", [(8, 100), (33, 257)])
def test_fused_linear_scan_matches_repro(jimpl, metric, q, n):
    qa, xa = _pair(metric, q, n)
    r = RADII[metric]
    ia, da, ma = tops.fused_linear_scan(_t(qa), _t(xa), r, metric)
    ib, db, mb = jops.fused_linear_scan(_j(qa), _j(xa), r, metric,
                                        impl=jimpl)
    assert ia.shape == da.shape == ma.shape == (q, n)
    assert ia.dtype == torch.int32 and ma.dtype == torch.bool
    np.testing.assert_array_equal(ia.numpy(), np.asarray(ib))
    np.testing.assert_array_equal(ma.numpy(), np.asarray(mb))
    np.testing.assert_allclose(da.numpy(), np.asarray(db), **TOL)
    assert int(ma.sum()) > 0


@pytest.mark.parametrize("jimpl", JAX_IMPLS)
@pytest.mark.parametrize("metric", ["l2", "l1", "cosine", "hamming"])
def test_fused_lsh_scan_handcrafted_matches_repro(jimpl, metric):
    n = 40
    qa, xa = _pair(metric, 3, n)
    ids = handcrafted_ids(n)
    r = RADII[metric]
    ia, da, ma = tops.fused_lsh_scan(_t(xa), torch.from_numpy(ids), _t(qa),
                                     r, metric)
    ib, db, mb = jops.fused_lsh_scan(_j(xa), _j(ids), _j(qa), r, metric,
                                     impl=jimpl)
    np.testing.assert_array_equal(ia.numpy(), np.asarray(ib))
    np.testing.assert_array_equal(ma.numpy(), np.asarray(mb))
    m = ma.numpy()
    np.testing.assert_allclose(da.numpy()[m], np.asarray(db)[m], **TOL)
    assert not m[2].any()
    for qi in range(2):
        rep = ia.numpy()[qi][m[qi]]
        assert len(rep) == len(set(rep.tolist()))


@pytest.mark.parametrize("jimpl", JAX_IMPLS)
@pytest.mark.parametrize("metric", ["l2", "l1", "cosine", "hamming"])
@pytest.mark.parametrize("n,q,c,kind", [
    (40, 3, 8, "handcrafted"), (40, 5, 33, "one_id"), (300, 7, 64, "boundary"),
    (300, 3, 50, "one_split"), (1, 2, 5, "random")])
def test_fused_lsh_scan_unsorted_matches_repro(jimpl, metric, n, q, c, kind):
    """``ops.fused_lsh_scan_unsorted`` (unsorted candidates, as the gather
    leaves them) against repro's ``jnp.sort`` + ``fused_lsh_scan``: shuffled
    duplicate runs, a sentinel share and an all-sentinel row, a row of one
    repeated id, ids at the boundaries of splits of 19 ids or inside one."""
    qa, xa = _pair(metric, q, n)
    if kind == "handcrafted":
        ids = RNG.permuted(handcrafted_ids(n), axis=1)
    else:
        ids = lsh_ids(kind, n, q, c, 19, RNG)
    r = RADII[metric]
    ia, da, ma = tops.fused_lsh_scan_unsorted(_t(xa), torch.from_numpy(ids),
                                              _t(qa), r, metric)
    ib, db, mb = jops.fused_lsh_scan(_j(xa), jnp.sort(_j(ids), axis=-1),
                                     _j(qa), r, metric, impl=jimpl)
    np.testing.assert_array_equal(ia.numpy(), np.asarray(ib))
    np.testing.assert_array_equal(ma.numpy(), np.asarray(mb))
    m = ma.numpy()
    np.testing.assert_allclose(da.numpy()[m], np.asarray(db)[m], **TOL)
    assert not m[-1].any()                # the all-sentinel row
    for qi in range(q):
        rep = ia.numpy()[qi][m[qi]]
        assert len(rep) == len(set(rep.tolist()))


@pytest.mark.parametrize("jimpl", JAX_IMPLS)
@pytest.mark.parametrize("metric", ["l2", "l1", "cosine", "hamming"])
def test_lsh_search_tidx_cap_odd_batch_matches_repro(jimpl, metric):
    """Real tables, multi-probe ``tidx``, cap truncation and a 33-query
    batch in 16-query chunks (pad rows carry sentinels)."""
    from repro.core.lsh.tables import build_tables as jbuild
    from repro.core.search import lsh_search as jlsh
    n, q, L, B, cap = 150, 33, 4, 8, 2
    qa, xa = _pair(metric, q, n)
    bids = RNG.integers(0, B, size=(n, L)).astype(np.int32)
    ids = np.arange(n, dtype=np.int32)
    jt = jbuild(_j(ids), _j(bids), B, 16)
    tt = build_tables(torch.from_numpy(ids), torch.from_numpy(bids), B, 16)
    tidx = np.repeat(np.arange(L), 2).astype(np.int32)
    qb = RNG.integers(0, B, size=(q, L * 2)).astype(np.int32)
    r = RADII[metric]
    a = tsearch.lsh_search(_t(xa), tt, torch.from_numpy(qb), _t(qa), r,
                           metric, cap, q_chunk=16,
                           tidx=torch.from_numpy(tidx))
    b = jlsh(_j(xa), jt, _j(qb), _j(qa), r, metric, cap, q_chunk=16,
             tidx=_j(tidx), impl=jimpl)
    assert tuple(a[0].shape) == (q, L * 2 * cap)
    np.testing.assert_array_equal(a[0].numpy(), np.asarray(b[0]))
    np.testing.assert_array_equal(a[2].numpy(), np.asarray(b[2]))
    m = a[2].numpy()
    np.testing.assert_allclose(a[1].numpy()[m], np.asarray(b[1])[m], **TOL)


@pytest.mark.parametrize("use_tidx", [False, True])
def test_candidate_counts_and_dedupe_match_repro(use_tidx):
    """The alpha-term helpers: sort-dedup and the distinct-candidate count
    of the cap-truncated gather, with and without multi-probe ``tidx``."""
    from repro.core import search as jsearch
    from repro.core.lsh.tables import build_tables as jbuild
    n, q, L, B, cap = 300, 11, 4, 8, 16
    bids = RNG.integers(0, B, size=(n, L)).astype(np.int32)
    ids = np.arange(n, dtype=np.int32)
    jt = jbuild(_j(ids), _j(bids), B, 16)
    tt = build_tables(torch.from_numpy(ids), torch.from_numpy(bids), B, 16)
    V = 2 * L if use_tidx else L
    qb = RNG.integers(0, B, size=(q, V)).astype(np.int32)
    tidx = np.repeat(np.arange(L), 2).astype(np.int32) if use_tidx else None
    got = tsearch.lsh_candidate_counts(
        tt, torch.from_numpy(qb), cap,
        tidx=None if tidx is None else torch.from_numpy(tidx))
    want = jsearch.lsh_candidate_counts(
        jt, _j(qb), cap, tidx=None if tidx is None else _j(tidx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.max()) <= V * cap
    cands = RNG.integers(0, n + 1, (q, 50)).astype(np.int32)
    for a, b in zip(tsearch.dedupe_sorted(torch.from_numpy(cands), n),
                    jsearch.dedupe_sorted(_j(cands), n)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("nq", [7, 32, 33, 65])
def test_linear_search_odd_batches_match_repro(nq):
    """Chunked == unchunked in the port, and both equal repro's."""
    from repro.core.search import linear_search as jlin
    qa, xa = _pair("l2", nq, 97)
    base = tsearch.linear_search(_t(xa), _t(qa), 7.0, "l2", q_chunk=0)
    want = jlin(_j(xa), _j(qa), 7.0, "l2", impl="ref", q_chunk=32)
    for q_chunk in (16, 32):
        got = tsearch.linear_search(_t(xa), _t(qa), 7.0, "l2",
                                    q_chunk=q_chunk)
        for ga, ba in zip(got, base):
            assert tuple(ga.shape) == (nq, 97)
            np.testing.assert_array_equal(ga.numpy(), ba.numpy())
    np.testing.assert_array_equal(base[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(base[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(base[1].numpy(), np.asarray(want[1]), **TOL)


@pytest.mark.parametrize("jimpl", JAX_IMPLS)
@pytest.mark.parametrize("q,L,m,kind", [
    (8, 3, 32, "random"), (64, 20, 128, "random"), (5, 1, 64, "random"),
    (7, 4, 64, "small"), (6, 2, 64, "large")])
def test_hll_merge_estimate_matches_repro(jimpl, q, L, m, kind):
    regs = hll_regs(q, L, m, kind, RNG)
    got = tops.hll_merge_estimate(torch.from_numpy(regs)).numpy()
    want = np.asarray(jops.hll_merge_estimate(_j(regs), impl=jimpl))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_plain_building_blocks_match_repro():
    qa, xa = _pair("l2", 9, 50)
    np.testing.assert_allclose(tref.pairwise_sql2(_t(qa), _t(xa)).numpy(),
                               np.asarray(jref.pairwise_sql2(_j(qa), _j(xa))),
                               **TOL)
    np.testing.assert_allclose(tref.pairwise_l1(_t(qa), _t(xa)).numpy(),
                               np.asarray(jref.pairwise_l1(_j(qa), _j(xa))),
                               **TOL)
    np.testing.assert_allclose(
        tref.pairwise_cosine(_t(qa), _t(xa)).numpy(),
        np.asarray(jref.pairwise_cosine(_j(qa), _j(xa))), **TOL)
    rows = RNG.normal(size=(9, 6, 37)).astype(np.float32)
    for metric in ("l2", "l1", "cosine"):
        np.testing.assert_allclose(
            tref.rowwise_dist(_t(rows), _t(qa), metric).numpy(),
            np.asarray(jref.rowwise_dist(_j(rows), _j(qa), metric)), **TOL)
    qc, xc = _pair("hamming", 9, 50)
    np.testing.assert_array_equal(tref.hamming(_t(qc), _t(xc)).numpy(),
                                  np.asarray(jref.hamming(_j(qc), _j(xc))))
    v = RNG.integers(0, 2**32, 1000, dtype=np.uint32)
    np.testing.assert_array_equal(tref.popcount_u32(_t(v)).numpy(),
                                  np.asarray(jref.popcount_u32(_j(v))))
    # int32 bit views count the same bits as their uint32 values
    np.testing.assert_array_equal(
        tref.popcount_u32(torch.from_numpy(v.view(np.int32))).numpy(),
        np.asarray(jref.popcount_u32(_j(v))))


def test_dispatch_rules():
    cpu = torch.zeros(1).device
    assert tops.resolve_impl(None, cpu) == "ref"
    assert tops.resolve_impl("ref", cpu) == "ref"
    assert tops.resolve_impl(None, "cuda") == "cuda"
    assert tops.resolve_impl("ref", "cuda") == "ref"
    with pytest.raises(ValueError):
        tops.resolve_impl("cuda", cpu)
    with pytest.raises(ValueError):
        tops.resolve_impl("pallas", cpu)
    qa, xa = _pair("l2", 4, 20)
    with pytest.raises(ValueError):
        tops.fused_linear_scan(_t(qa), _t(xa), 1.0, "l2", impl="cuda")
    with pytest.raises(ValueError):       # wrappers launch on CUDA only
        hll_merge.hll_merge_estimate(torch.zeros((2, 3, 16), dtype=torch.uint8))
    assert tops.metric_radius_transform("l2", 3.0) == 9.0
    assert tops.metric_radius_transform("cosine", 0.5) == 0.5
    padded = tops.pad_to(torch.ones(5, 2), 4, 0, value=7)
    assert tuple(padded.shape) == (8, 2) and float(padded[-1, 0]) == 7


# ---------------------------------------------------------------------------
# The shapes of the L1 and Hamming linear scans (K4, K5): their plain
# versions, which the CUDA kernels are held against on the card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("jimpl", JAX_IMPLS)
@pytest.mark.parametrize("q,n,d", [(1, 1, 54), (33, 257, 54), (33, 257, 37),
                                   (5, 130, 1)])
def test_l1_linear_scan_odd_shapes_match_repro(jimpl, q, n, d):
    """d = 54 (CoverType) and 37 are not multiples of the kernels' chunk;
    odd Q and N leave partial tiles."""
    qa = RNG.normal(size=(q, d)).astype(np.float32)
    xa = RNG.normal(size=(n, d)).astype(np.float32)
    r = 0.9 * float(np.median(np.abs(qa[:, None] - xa[None]).sum(-1)))
    ia, da, ma = tops.fused_linear_scan(_t(qa), _t(xa), r, "l1")
    ib, db, mb = jops.fused_linear_scan(_j(qa), _j(xa), r, "l1", impl=jimpl)
    np.testing.assert_array_equal(ia.numpy(), np.asarray(ib))
    np.testing.assert_array_equal(ma.numpy(), np.asarray(mb))
    np.testing.assert_allclose(da.numpy(), np.asarray(db), **TOL)


@pytest.mark.parametrize("jimpl", JAX_IMPLS)
@pytest.mark.parametrize("w", [1, 2, 3, 8, 9, 16])
def test_hamming_linear_scan_words_and_ties_match_repro(jimpl, w):
    """W = 1..16 packed words, an all-zero code, and a threshold equal to
    an attained distance (equality reports)."""
    qa = RNG.integers(0, 2**32, (7, w), dtype=np.uint32)
    xa = RNG.integers(0, 2**32, (300, w), dtype=np.uint32)
    qa[0] = 0
    xa[5] = 0
    r = float(np.unpackbits((qa[1] ^ xa[17]).view(np.uint8)).sum())
    ia, da, ma = tops.fused_linear_scan(_t(qa), _t(xa), r, "hamming")
    ib, db, mb = jops.fused_linear_scan(_j(qa), _j(xa), r, "hamming",
                                        impl=jimpl)
    np.testing.assert_array_equal(ia.numpy(), np.asarray(ib))
    np.testing.assert_array_equal(ma.numpy(), np.asarray(mb))
    np.testing.assert_array_equal(da.numpy(), np.asarray(db))
    assert bool(ma[1, 17]) and float(da[1, 17]) == r
    assert float(da[0, 5]) == 0.0 and bool(ma[0, 5])


@pytest.mark.parametrize("block_elems", [1, 37 * 9 * 10, 1 << 24])
def test_pairwise_l1_blocks_give_the_same_sums(block_elems, monkeypatch):
    """The plain L1 works over N in blocks; every block size gives the
    bitwise-same distances (each is one sum over d)."""
    monkeypatch.setattr(tref, "L1_BLOCK_ELEMS", block_elems)
    qa = RNG.normal(size=(9, 37)).astype(np.float32)
    xa = RNG.normal(size=(101, 37)).astype(np.float32)
    whole = torch.sum(torch.abs(_t(qa)[:, None] - _t(xa)[None]), dim=-1)
    assert torch.equal(tref.pairwise_l1(_t(qa), _t(xa)), whole)


@pytest.mark.parametrize("metric", ["l1", "hamming"])
def test_l1_and_hamming_wrappers_launch_on_cuda_only(metric):
    from repro_torch.kernels import fused_scan
    qa, xa = _pair(metric, 4, 20)
    if metric == "hamming":
        q, x = (torch.from_numpy(a.view(np.int32)) for a in (qa, xa))
        fn = fused_scan.linear_scan_hamming
        args = (q, [tops.ScanPart(x)])      # a group of one segment
    else:
        q, x = _t(qa), _t(xa)
        fn = fused_scan.linear_scan_l1
        args = (q, x)
    before = fn.launches
    with pytest.raises(ValueError, match="CUDA"):
        fn(1.0, *args)
    with pytest.raises(ValueError):
        tops.fused_linear_scan(q, x, 1.0, metric, impl="cuda")
    assert fn.launches == before
