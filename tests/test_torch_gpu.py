"""The CUDA kernels against their plain PyTorch versions, on a card.

Imports neither JAX nor ``repro``, so it runs on a GPU machine without
them:  ``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.
Every test skips (with its reason) where there is no CUDA device: the
kernels have no CPU mode.  Tolerances as in ``test_torch_kernels.py``;
HLL estimates at rtol 1e-5 against the plain version (float32 sums in
another order) and bit for bit against the per-segment composition of the
same kernel; Hamming matrices and scans exact; SimHash bits as
``torch_cases.simhash_flips`` allows.
"""
import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import multiprobe as mp  # noqa: E402
from repro_torch.core.lsh import families  # noqa: E402
from repro_torch.kernels import (bucket_hash, delta_collide,  # noqa: E402
                                 distances, fused_scan, hamming, hll_merge,
                                 ops, simhash)
from repro_torch.kernels.ref import unit_rows  # noqa: E402
from repro_torch.kernels.ref import EXT_SENTINEL  # noqa: E402
from torch_cases import (BUCKET_HASH_B, BUCKET_HASH_CASES,  # noqa: E402
                         MULTIPROBE_CASES, bucket_hash_case, np_bucket_ids,
                         np_mix_words)
from torch_cases import (DELTA_COUNTS, DELTA_FULL,  # noqa: E402
                         DELTA_PROBES, delta_case, delta_full_chain)
from torch_cases import (DOT_CASES, GROUPED_CASES, L1_CASES,  # noqa: E402
                         LSH_CASES, MESH_SERVE_CASES, MESH_SITES,
                         MESH_TRAIN_CASES, RADII, ROUTE_CASES, SCAN_CASES,
                         SERVE_ARCHS, SIMHASH_CASES, TOL, TRAIN_CASES,
                         as_tensor, dist64, dot_inputs, grouped_parts,
                         handcrafted_ids, hll_regs, l1_inputs, lsh_dist64,
                         lsh_inputs, masks_outside_band_agree,
                         mesh_site_device_vs_cpu, on_device,
                         pair, route_estimate_per_segment, route_tables,
                         scan_device_vs_cpu, serve_device_vs_cpu,
                         simhash_flips, simhash_inputs,
                         train_device_vs_cpu, unit_rows_np)

RNG = np.random.default_rng(0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


LINEAR_KERNEL = {"l2": "linear_scan_dot", "cosine": "linear_scan_dot",
                 "l1": "linear_scan_l1", "hamming": "linear_scan_hamming"}


# l1 and Hamming at d = 37 / W = 3; the dot form (K1) on DOT_CASES too:
# Q across n-fragments and query groups, N = 1, d through each copy width,
# views of the corpus, zero rows and rows within 1e-4 of the threshold.
LINEAR_CASES = ([(m, q, n, 37, None) for m in ("l2", "cosine", "l1", "hamming")
                 for q, n in ((8, 100), (33, 257), (65, 1000))]
                + [(m, *c) for m in ("l2", "cosine") for c in DOT_CASES])


@pytest.mark.gpu
@pytest.mark.parametrize("metric,q,n,d,view", LINEAR_CASES)
def test_cuda_linear_scan_matches_plain(cuda, metric, q, n, d, view):
    kernel = getattr(fused_scan, LINEAR_KERNEL[metric])
    x_unit = None
    if metric in ("l1", "hamming"):
        qa, xa = pair(metric, q, n, RNG)
        qt, xt = as_tensor(qa).to(cuda), as_tensor(xa).to(cuda)
        r = RADII[metric]
    else:
        qa, xa, t = dot_inputs(metric, q, n, d, RNG)
        qt, xt = torch.from_numpy(qa).to(cuda), on_device(xa, view, cuda)
        r = t if metric == "cosine" else float(np.sqrt(t))
        if metric == "cosine":
            x_unit = on_device(unit_rows_np(xa), view, cuda)
    before = kernel.launches
    a = ops.fused_linear_scan(qt, xt, r, metric, impl="cuda", x_unit=x_unit)
    b = ops.fused_linear_scan(qt, xt, r, metric, impl="ref")
    assert kernel.launches == before + 1
    np.testing.assert_array_equal(a[0].cpu().numpy(), b[0].cpu().numpy())
    np.testing.assert_allclose(a[1].cpu().numpy(), b[1].cpu().numpy(), **TOL)
    if metric in ("l1", "hamming"):
        np.testing.assert_array_equal(a[2].cpu().numpy(), b[2].cpu().numpy())
        return
    masks_outside_band_agree(a[2].cpu().numpy(), b[2].cpu().numpy(),
                             dist64(metric, qa, xa), t)
    if metric == "cosine" and view is None:   # unit rows made once by the caller
        c = ops.fused_linear_scan(qt, xt, r, metric, impl="cuda")
        e = ops.fused_linear_scan(qt, xt, r, metric, impl="cuda",
                                  x_unit=unit_rows(xt).contiguous())
        assert all(torch.equal(u, v) for u, v in zip(c, e))


@pytest.mark.gpu
@pytest.mark.parametrize("w", [1, 2, 3, 8, 9, 16])
def test_cuda_hamming_scan_words_zero_codes_and_ties(cuda, w):
    """W = 1..16 words (chunks of 8 and a partial chunk), all-zero codes, and a threshold equal to an
    attained distance: the kernel reports exactly what the plain version
    does (Hamming distances are exact)."""
    qa = RNG.integers(0, 2**32, (33, w), dtype=np.uint32)
    xa = RNG.integers(0, 2**32, (257, w), dtype=np.uint32)
    qa[0] = 0
    xa[:3] = 0
    r = float(np.unpackbits((qa[1] ^ xa[17]).view(np.uint8)).sum())
    qt = torch.from_numpy(qa.view(np.int32)).to(cuda)
    xt = torch.from_numpy(xa.view(np.int32)).to(cuda)
    a = ops.fused_linear_scan(qt, xt, r, "hamming", impl="cuda")
    b = ops.fused_linear_scan(qt, xt, r, "hamming", impl="ref")
    for u, v in zip(a, b):
        assert torch.equal(u, v.contiguous())
    assert bool(a[2][1, 17])


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["l2", "l1", "cosine", "hamming"])
def test_cuda_lsh_scan_matches_plain(cuda, metric):
    n = 40
    qa, xa = pair(metric, 3, n, RNG)
    ids = torch.from_numpy(handcrafted_ids(n)).to(cuda)
    args = (as_tensor(xa).to(cuda), ids, as_tensor(qa).to(cuda),
            RADII[metric], metric)
    before = fused_scan.lsh_scan.launches
    a = ops.fused_lsh_scan(*args, impl="cuda")
    b = ops.fused_lsh_scan(*args, impl="ref")
    assert fused_scan.lsh_scan.launches == before + 1
    m = a[2].cpu().numpy()
    np.testing.assert_array_equal(m, b[2].cpu().numpy())
    assert not m[2].any()
    np.testing.assert_allclose(a[1].cpu().numpy()[m], b[1].cpu().numpy()[m],
                               **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("metric,d,n,q,c,kind", LSH_CASES)
def test_cuda_lsh_scan_unsorted_matches_plain(cuda, metric, d, n, q, c, kind):
    """The fused K2 (sort, dedup, gather, verify) from unsorted ids against
    torch.sort + the plain verification: ids bit-equal, masks equal off
    the 1e-5 band of the threshold, distances within TOL under both
    masks.  Cosine runs twice: on x (``ops`` scales the rows) and on the
    unit rows the indexes keep (``x_unit``)."""
    dtype = torch.int32 if metric == "hamming" else torch.float32
    width = fused_scan.lsh_scan_plan(
        torch.empty((n, d), dtype=dtype, device=cuda), q, c)["width"]
    qa, xa, ids, t, r = lsh_inputs(metric, d, n, q, c, kind, width, RNG)
    args = (as_tensor(xa).to(cuda), torch.from_numpy(ids).to(cuda),
            as_tensor(qa).to(cuda), r, metric)
    b = ops.fused_lsh_scan_unsorted(*args, impl="ref")
    ids_p = b[0].cpu().numpy()
    d64 = lsh_dist64(metric, qa, xa, ids_p)
    units = [None, unit_rows(args[0]).contiguous()] if metric == "cosine" else [None]
    for x_unit in units:
        before = fused_scan.lsh_scan.launches
        a = ops.fused_lsh_scan_unsorted(*args, impl="cuda", x_unit=x_unit)
        assert fused_scan.lsh_scan.launches == before + 1
        np.testing.assert_array_equal(a[0].cpu().numpy(), ids_p)
        mk, mp = a[2].cpu().numpy(), b[2].cpu().numpy()
        masks_outside_band_agree(mk, mp, d64, t)
        both = mk & mp
        np.testing.assert_allclose(a[1].cpu().numpy()[both],
                                   b[1].cpu().numpy()[both], **TOL)
        if q > 1:
            assert not mk[-1].any()


# search.lsh_search over one segment, C = L cap: Webspam's width (cosine on
# the unit rows the index keeps, 350,000 x 254) and CoverType's (l1, a
# frozen segment of 2^20 rows x 54) at C = 5,120 and 1, 32, 33 and 1,024
# queries; 65,537 queries at C = 32 (two launches: the grid holds 65,535
# queries); 1,024 queries whose candidates all lie in the first of 2^20
# rows' four splits, more distinct ids than a block holds at once.
LSH_GROUP_CASES = (
    [("cosine", 254, 350_000, nq, 20, 256, "random") for nq in (1, 32, 33, 1024)]
    + [("l1", 54, 1 << 20, nq, 20, 256, "random") for nq in (1, 32, 33, 1024)]
    + [("l1", 54, 4096, 65537, 4, 8, "random"),
       ("l1", 54, 1 << 20, 1024, 20, 256, "one_split")])


def _group_tables(n, L, kind, gen, dev):
    """CSR tables over n rows and the buckets a query may probe: random
    buckets of about 300 rows, or ("one_split") buckets of 256 rows of
    [0, n / 4), grouped at random in each table, the other rows in buckets
    no query probes."""
    from repro_torch.core.lsh.tables import build_tables
    if kind == "one_split":
        probed = n // 4 // 256
        bids = torch.cat([
            torch.stack([torch.randperm(n // 4, generator=gen, device=dev) // 256
                         for _ in range(L)], 1),
            torch.randint(probed, 2 * probed, (n - n // 4, L), generator=gen,
                          device=dev)])
        buckets = 2 * probed
    else:
        buckets = probed = max(1, n // 300)
        bids = torch.randint(0, buckets, (n, L), generator=gen, device=dev)
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    return build_tables(ids, bids, buckets, 16), probed


@pytest.mark.gpu
@pytest.mark.parametrize("metric,d,n,nq,L,cap,kind", LSH_GROUP_CASES)
def test_cuda_lsh_search_verifies_a_group_in_one_launch(cuda, metric, d, n,
                                                        nq, L, cap, kind):
    """``search.lsh_search`` launches K2 once for the whole group (once a
    65,535 queries past the grid's limit), and its ids, mask and distances
    equal, bit for bit, the 32-query slices of
    ``ops.fused_lsh_scan_unsorted`` that the LSH route ran before."""
    from repro_torch.core import search
    from repro_torch.core.lsh.tables import gather_candidates
    gen = torch.Generator(device=cuda).manual_seed(nq)
    x = torch.randn((n, d), generator=gen, device=cuda)
    q = torch.randn((nq, d), generator=gen, device=cuda)
    tables, probed = _group_tables(n, L, kind, gen, cuda)
    qb = torch.randint(0, probed, (nq, L), generator=gen, device=cuda)
    x_unit = unit_rows(x).contiguous() if metric == "cosine" else None
    r = 1.0 if metric == "cosine" else 61.0       # about half reported
    before = fused_scan.lsh_scan.launches
    got = search.lsh_search(x, tables, qb, q, r, metric, cap, x_unit=x_unit)
    assert fused_scan.lsh_scan.launches - before == \
        -(-nq // fused_scan.LSH_MAX_QUERIES)
    cands = gather_candidates(tables, qb, cap, n)
    want = ops.chunked(lambda a: ops.fused_lsh_scan_unsorted(
        x, a[0], a[1], r, metric, impl="cuda", x_unit=x_unit), (cands, q),
        (n, 0))
    for u, v in zip(got, want):
        assert tuple(u.shape) == (nq, L * cap)
        assert torch.equal(u, v)
    first = search.dedupe_sorted(got[0], n)[1]
    assert 0 < int(got[2].sum()) < int(first.sum())
    if kind == "one_split":
        plan = fused_scan.lsh_scan_plan(x, nq, L * cap)
        held = (first & (got[0] < plan["width"])).sum(1)
        assert plan["splits"] == 4
        assert int(held.min()) > plan["distinct_at_once"], plan


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["linear_scan_l1", "pairwise_l1"])
@pytest.mark.parametrize("q,n,d,view", L1_CASES)
def test_cuda_l1_tile_matches_plain(cuda, mode, q, n, d, view):
    """K4 (through ``ops.fused_linear_scan``) and K7 (through
    ``ops.pairwise_dist``) against the plain L1 on the L1 tile's edge
    shapes: exact ids, distances within TOL, masks equal off the 1e-5 band
    of a threshold at an attained distance."""
    qa, xa, t = l1_inputs(q, n, d, RNG)
    qt, xt = torch.from_numpy(qa).to(cuda), on_device(xa, view, cuda)
    kernel = getattr(fused_scan if mode == "linear_scan_l1" else distances, mode)
    before = kernel.launches
    if mode == "pairwise_l1":
        a = ops.pairwise_dist(qt, xt, "l1", impl="cuda")
        b = ops.pairwise_dist(qt, xt, "l1", impl="ref")
        assert kernel.launches == before + 1
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), **TOL)
        return
    a = ops.fused_linear_scan(qt, xt, t, "l1", impl="cuda")
    b = ops.fused_linear_scan(qt, xt, t, "l1", impl="ref")
    assert kernel.launches == before + 1
    np.testing.assert_array_equal(a[0].cpu().numpy(), b[0].cpu().numpy())
    np.testing.assert_allclose(a[1].cpu().numpy(), b[1].cpu().numpy(), **TOL)
    masks_outside_band_agree(a[2].cpu().numpy(), b[2].cpu().numpy(),
                             dist64("l1", qa, xa), t)


@pytest.mark.gpu
@pytest.mark.parametrize("q,L,m,kind", [
    (8, 3, 32, "random"), (64, 20, 128, "random"), (7, 4, 64, "small"),
    (6, 2, 64, "large"), (3, 2, 16, "random")])
def test_cuda_hll_merge_matches_plain(cuda, q, L, m, kind):
    regs = torch.from_numpy(hll_regs(q, L, m, kind, RNG)).to(cuda)
    before = hll_merge.hll_merge_estimate.launches
    a = ops.hll_merge_estimate(regs, impl="cuda")
    b = ops.hll_merge_estimate(regs, impl="ref")
    assert hll_merge.hll_merge_estimate.launches == before + 1
    np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=1e-5)


def _on(a, cuda):
    return None if a is None else torch.from_numpy(a).to(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("q,L,T,m,S,kind", ROUTE_CASES)
def test_cuda_route_estimate_matches_plain(cuda, q, L, T, m, S, kind):
    """K3 over S segments: collisions exact and the estimate within 1e-5
    of the plain version; bit for bit the sum the engine composed one
    segment at a time from the kernel's one-segment case; one launch per
    64 segments."""
    qb, tidx, segs = route_tables(q, L, T, m, S, kind, RNG)
    qb, tidx = _on(qb, cuda), _on(tidx, cuda)
    tables = [ops.TableTerms(*(_on(a, cuda) for a in seg)) for seg in segs]
    before = hll_merge.route_estimate.launches
    coll, cand = ops.route_estimate(qb, tables, tidx, impl="cuda")
    assert hll_merge.route_estimate.launches == before + -(-S // 64)
    pc, pe = ops.route_estimate(qb, tables, tidx, impl="ref")
    assert torch.equal(coll, pc)
    np.testing.assert_allclose(cand.cpu().numpy(), pe.cpu().numpy(), rtol=1e-5)
    wc, we = route_estimate_per_segment(
        qb, tables, tidx, lambda r: ops.hll_merge_estimate(r, impl="cuda"))
    assert torch.equal(coll, wc) and torch.equal(cand, we)


@pytest.mark.gpu
@pytest.mark.parametrize("q,L,T,m,S,kind", ROUTE_CASES)
def test_cuda_route_terms_matches_plain(cuda, q, L, T, m, S, kind):
    """K3's terms mode over S segments (what a sharded index merges
    across its shards): each segment's collisions, dead counts and merged
    registers bit for bit the plain version's; one launch per 64
    segments."""
    qb, tidx, segs = route_tables(q, L, T, m, S, kind, RNG)
    qb, tidx = _on(qb, cuda), _on(tidx, cuda)
    tables = [ops.TableTerms(*(_on(a, cuda) for a in seg)) for seg in segs]
    before = hll_merge.route_terms.launches
    got = ops.route_terms(qb, tables, tidx, impl="cuda")
    assert hll_merge.route_terms.launches == before + -(-S // 64)
    for a, b in zip(got, ops.route_terms(qb, tables, tidx, impl="ref")):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("q,w,sizes,kind", GROUPED_CASES)
def test_cuda_grouped_hamming_scan_matches_plain(cuda, q, w, sizes, kind):
    """K5 over a group of segments, all queries in one launch per 64
    segments: ids, distances and masks equal the plain version's (per
    segment the plain scan, the live / external-id epilogue, and a
    concatenation); a segment of dead rows reports nothing."""
    qa, parts, t = grouped_parts(q, w, sizes, kind, RNG)
    qt = torch.from_numpy(qa.view(np.int32)).to(cuda)
    tparts = [ops.ScanPart(torch.from_numpy(x.view(np.int32)).to(cuda),
                           _on(live, cuda), _on(ext, cuda))
              for x, live, ext in parts]
    before = fused_scan.linear_scan_hamming.launches
    a = ops.grouped_linear_scan(qt, tparts, t, "hamming", impl="cuda")
    assert fused_scan.linear_scan_hamming.launches == before + -(-len(sizes) // 64)
    b = ops.grouped_linear_scan(qt, tparts, t, "hamming", impl="ref")
    assert tuple(a[0].shape) == (q, sum(sizes))
    for u, v in zip(a, b):
        assert u.dtype == v.dtype and torch.equal(u, v)
    if kind == "dead":
        assert not bool(a[2][:, :sizes[0]].any())
        assert bool((a[0][:, :sizes[0]] == EXT_SENTINEL).all())
    assert bool(b[2].any())


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["l2", "cosine", "l1"])
def test_cuda_grouped_linear_scan_matches_plain(cuda, metric):
    """The grouped scan of l2 / cosine / l1 on CUDA: K1 or K4 on each part
    that holds rows, once a 32-query slice, then the live / external-id
    epilogue.  Over a static part (with its unit rows for cosine), a part
    of no rows and a streaming part (live, external ids): ids, distances
    and masks as the plain grouped scan's (masks off the threshold
    band); the part of no rows launches nothing and adds no column."""
    nq, d, sizes = 70, 37, (300, 0, 129)
    qa = RNG.normal(size=(nq, d)).astype(np.float32)
    xs = [RNG.normal(size=(n, d)).astype(np.float32) for n in sizes]
    t = float(np.median(dist64(metric, qa[:1], xs[0])))
    r = float(np.sqrt(t)) if metric == "l2" else t
    live = RNG.random(sizes[2] + 1) < 0.8
    ext = (1000 + RNG.permutation(sizes[2])).astype(np.int32)
    x0 = torch.from_numpy(xs[0]).to(cuda)
    parts = [ops.ScanPart(x0, x_unit=unit_rows(x0).contiguous()
                          if metric == "cosine" else None),
             ops.ScanPart(torch.from_numpy(xs[1]).to(cuda)),
             ops.ScanPart(torch.from_numpy(xs[2]).to(cuda), _on(live, cuda),
                          _on(ext, cuda))]
    qt = torch.from_numpy(qa).to(cuda)
    kernel = getattr(fused_scan, LINEAR_KERNEL[metric])
    before = kernel.launches
    a = ops.grouped_linear_scan(qt, parts, r, metric, impl="cuda")
    assert kernel.launches == before + 2 * -(-nq // 32)
    b = ops.grouped_linear_scan(qt, parts, r, metric, impl="ref")
    assert tuple(a[0].shape) == tuple(b[0].shape) == (nq, sum(sizes))
    ids, dists, mask = (u.cpu().numpy() for u in a)
    pids, pdists, pmask = (v.cpu().numpy() for v in b)
    np.testing.assert_allclose(dists, pdists, **TOL)
    alive = np.concatenate([np.ones(sizes[0], bool), live[:sizes[2]]])
    d64 = np.concatenate([dist64(metric, qa, x) for x in xs], axis=1)
    masks_outside_band_agree(mask, pmask, np.where(alive, d64, np.inf), t)
    both = mask & pmask
    np.testing.assert_array_equal(ids[both], pids[both])
    assert (ids[:, sizes[0]:][~mask[:, sizes[0]:]] == EXT_SENTINEL).all()
    assert mask.any() and not mask.all()


@pytest.mark.gpu
def test_cuda_index_default_device(cuda):
    from repro_torch.core import HybridLSHIndex
    from repro_torch.core.lsh import make_family
    x = RNG.normal(size=(500, 16)).astype(np.float32)
    idx = HybridLSHIndex(make_family("l2", d=16, L=4, r=2.0),
                         num_buckets=64).build(x)
    assert idx.x.is_cuda and idx.tables.perm.is_cuda
    before = hll_merge.route_estimate.launches
    res = idx.query(x[:20], 2.0)
    assert hll_merge.route_estimate.launches == before + 1
    for i in range(20):
        assert i in res.neighbors(i)


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["l1", "hamming"])
def test_cuda_churned_dynamic_index_matches_plain(cuda, metric):
    """A small churned DynamicHybridIndex (freezes, a merge, deletes in
    segments and the delta) through the kernels and through the plain
    versions reports the same sets on every route, with one K3 launch a
    query batch over all segments and, for Hamming, one K5 launch a
    linear group and one for the delta of an LSH group."""
    from repro_torch.core.lsh import make_family
    from repro_torch.streaming import CompactionPolicy, DynamicHybridIndex
    if metric == "hamming":
        x = RNG.integers(0, 2**32, (900, 2), dtype=np.uint32)
        fam, r = make_family("hamming", d=64, L=6, r=16.0), 24.0
    else:
        x = RNG.normal(size=(900, 16)).astype(np.float32)
        fam, r = make_family("l1", d=16, L=6, r=4.0), 9.0
    kw = dict(num_buckets=128, m=32, cap=512, delta_capacity=128,
              policy=CompactionPolicy(fanout=2))
    idx = DynamicHybridIndex(fam, seed=0, device=cuda, **kw).build(x[:500])
    idx.insert(x[500:])
    idx.delete(list(range(0, 500, 7)) + list(range(880, 900)))
    plain = DynamicHybridIndex(fam, params=idx.params, impl="ref",
                               device=cuda, **kw)
    plain.load_state_dict(idx.state_dict())
    kernel = getattr(fused_scan, LINEAR_KERNEL[metric])
    q = x[::45]
    assert len(idx.stack.segments) >= 2     # one K3 launch over both
    for force in (None, "lsh", "linear"):
        before = kernel.launches
        k3 = hll_merge.route_estimate.launches
        a = idx.query(q, r, force=force)
        assert hll_merge.route_estimate.launches == k3 + 1
        if metric == "hamming":
            assert kernel.launches == before + (len(a.lin_idx) > 0) \
                + (len(a.lsh_idx) > 0)
        else:
            assert kernel.launches > before   # the delta scan, at least
        b = plain.query(q, r, force=force)
        assert a.neighbor_sets() == b.neighbor_sets(), force


def _delta_collide_matches_plain(delta, qb, tidx):
    """Both modes of the collision test kernel over the delta's held rows
    against the plain chain and the full-capacity chain, bit for bit: one
    launch a mode, none without rows."""
    n = delta.count
    rows, live = delta.bucket_ids[:n], delta.live[:n]
    before = delta_collide.delta_collide.launches
    coll, dist = ops.delta_collide(qb, rows, live, tidx, "counts")
    mask = ops.delta_collide(qb, rows, live, tidx, "mask")
    assert delta_collide.delta_collide.launches == before + 2 * (n > 0)
    want_coll, want_dist = ops.delta_collide(qb, rows, live, tidx, "counts",
                                             impl="ref")
    want_mask = ops.delta_collide(qb, rows, live, tidx, "mask", impl="ref")
    assert coll.dtype == dist.dtype == torch.int32 and mask.dtype == torch.bool
    assert mask.shape == (qb.shape[0], n)
    assert torch.equal(coll, want_coll) and torch.equal(dist, want_dist)
    assert torch.equal(mask, want_mask)
    full_coll, full_dist = delta_full_chain(delta, qb, tidx, "counts")
    assert torch.equal(coll, full_coll) and torch.equal(dist, full_dist)
    assert torch.equal(mask, delta_full_chain(delta, qb, tidx,
                                              "mask")[:, :n])
    return coll


@pytest.mark.gpu
@pytest.mark.parametrize("probes", DELTA_PROBES)
@pytest.mark.parametrize("count", DELTA_COUNTS)
def test_cuda_delta_collide_matches_plain(cuda, count, probes):
    delta, _, qb, tidx = delta_case(count, probes, cuda, seed=count)
    coll = _delta_collide_matches_plain(delta, qb, tidx)
    if count > 1:        # some live row collides (a lone row may be dead)
        assert bool((coll > 0).any())


@pytest.mark.gpu
@pytest.mark.parametrize("probes", DELTA_PROBES)
def test_cuda_delta_collide_full_delta(cuda, probes):
    """The CoverType batch (1,024 queries, L = 20) against a full delta of
    8,192 rows: eight row chunks a query tile, the counts added."""
    delta, _, qb, tidx = delta_case(DELTA_FULL["C"], probes, cuda,
                                    **DELTA_FULL)
    coll = _delta_collide_matches_plain(delta, qb, tidx)
    assert int(coll.min()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["l1", "hamming"])
def test_cuda_empty_delta_launches_nothing_in_the_search(cuda, metric):
    """A freshly built DynamicHybridIndex (its delta empty): a query batch
    launches no collision test (its counts are zeros) and, on the LSH
    route, no linear scan (the delta's scan has no rows); every batch
    counts in ``delta_empty_batches``; the sets equal the plain path's.
    Once the delta holds rows, a batch launches the counts once and the
    mask once an LSH group, and counts in ``delta_kernel_batches``."""
    from repro_torch.core.lsh import make_family
    from repro_torch.streaming import DynamicHybridIndex
    if metric == "hamming":
        x = RNG.integers(0, 2**32, (900, 2), dtype=np.uint32)
        fam, r = make_family("hamming", d=64, L=6, r=16.0), 24.0
    else:
        x = RNG.normal(size=(900, 16)).astype(np.float32)
        fam, r = make_family("l1", d=16, L=6, r=4.0), 9.0
    kw = dict(num_buckets=128, m=32, cap=512, delta_capacity=128)
    idx = DynamicHybridIndex(fam, seed=0, device=cuda, **kw).build(x[:800])
    plain = DynamicHybridIndex(fam, params=idx.params, impl="ref",
                               device=cuda, **kw).build(x[:800])
    kernel = getattr(fused_scan, LINEAR_KERNEL[metric])
    q = x[::45]
    for force in (None, "lsh", "linear"):
        lin, dc = kernel.launches, delta_collide.delta_collide.launches
        a = idx.query(q, r, force=force)
        assert delta_collide.delta_collide.launches == dc, force
        assert (kernel.launches > lin) == (len(a.lin_idx) > 0), force
        assert a.neighbor_sets() == plain.query(q, r,
                                                force=force).neighbor_sets()
    st = idx.index_stats()
    assert (st["delta_empty_batches"], st["delta_kernel_batches"]) == (3, 0)
    idx.insert(x[800:])
    plain.insert(x[800:])
    for force in (None, "lsh", "linear"):
        dc = delta_collide.delta_collide.launches
        a = idx.query(q, r, force=force)
        assert delta_collide.delta_collide.launches == dc + 1 + (
            len(a.lsh_idx) > 0), force
        assert a.neighbor_sets() == plain.query(q, r,
                                                force=force).neighbor_sets()
    st = idx.index_stats()
    assert (st["delta_empty_batches"], st["delta_kernel_batches"]) == (3, 3)


# Every metric on six shapes; the dot form (K6) on DOT_CASES too.
PAIRWISE_CASES = ([(m, q, n, d, None) for m in ("l2", "cosine", "l1")
                   for q, n, d in ((1, 129, 37), (8, 100, 37), (33, 257, 254),
                                   (100, 1000, 54), (65, 1, 32), (7, 300, 1))]
                  + [(m, *c) for m in ("l2", "cosine") for c in DOT_CASES])


@pytest.mark.gpu
@pytest.mark.parametrize("metric,q,n,d,view", PAIRWISE_CASES)
def test_cuda_pairwise_dist_matches_plain(cuda, metric, q, n, d, view):
    """Odd Q and N (partial tiles), Q or N = 1, d not a multiple of the
    d-chunk, an all-zero row on each side (cosine's 1e-12 norm clamp);
    for the dot form also views of the corpus (the kernel on the unit
    rows for cosine, which ``ops`` would copy)."""
    if view is None:
        qa = RNG.normal(size=(q, d)).astype(np.float32)
        xa = RNG.normal(size=(n, d)).astype(np.float32)
        qa[0] = 0.0
        xa[-1] = 0.0
    else:
        qa, xa, _ = dot_inputs(metric, q, n, d, RNG)
    qt, xt = torch.from_numpy(qa).to(cuda), on_device(xa, view, cuda)
    kernel = distances.pairwise_l1 if metric == "l1" else distances.pairwise_dot
    before = kernel.launches
    if metric == "cosine" and view is not None:
        a = distances.pairwise_dot(unit_rows(qt).contiguous(),
                                   on_device(unit_rows_np(xa), view, cuda),
                                   None, None, mode="cosine")
    else:
        a = ops.pairwise_dist(qt, xt, metric, impl="cuda")
    b = ops.pairwise_dist(qt, xt, metric, impl="ref")
    assert kernel.launches == before + 1
    assert a.dtype == torch.float32 and a.shape == (q, n)
    np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["l2", "cosine", "l1"])
def test_cuda_pairwise_dist_f16_inputs(cuda, metric):
    """f16 inputs are cast to float32 first, as the plain version casts."""
    qt = torch.from_numpy(RNG.normal(size=(16, 32)).astype(np.float16)).to(cuda)
    xt = torch.from_numpy(RNG.normal(size=(64, 32)).astype(np.float16)).to(cuda)
    a = ops.pairwise_dist(qt, xt, metric, impl="cuda")
    b = ops.pairwise_dist(qt, xt, metric, impl="ref")
    np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("w", [1, 2, 3, 8, 9, 16])
@pytest.mark.parametrize("q,n", [(1, 1), (33, 257), (100, 1000)])
def test_cuda_hamming_dist_is_exact(cuda, w, q, n):
    qa = RNG.integers(0, 2**32, (q, w), dtype=np.uint32)
    xa = RNG.integers(0, 2**32, (n, w), dtype=np.uint32)
    xa[0] = qa[0]
    qt = torch.from_numpy(qa.view(np.int32)).to(cuda)
    xt = torch.from_numpy(xa.view(np.int32)).to(cuda)
    before = hamming.hamming.launches
    a = ops.hamming_dist(qt, xt, impl="cuda")
    b = ops.hamming_dist(qt, xt, impl="ref")
    assert hamming.hamming.launches == before + 1
    assert a.dtype == torch.int32 and torch.equal(a, b)
    assert int(a[0, 0]) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("L,k", [(3, 8), (5, 31), (2, 32), (4, 40), (1, 64),
                                 (20, 21), (7, 1), (20, 4), (3, 16)])
@pytest.mark.parametrize("n,d", [(1, 37), (130, 48), (1000, 254)])
def test_cuda_simhash_matches_plain(cuda, L, k, n, d):
    """Bits are equal except where the float64 projection lies within
    1e-5 * sum |x_i r_i| of 0 (float32 sums in another order)."""
    x = torch.from_numpy(RNG.normal(size=(n, d)).astype(np.float32)).to(cuda)
    x[0] = 0.0                        # every projection 0.0: all bits 0
    r = torch.from_numpy(RNG.normal(size=(d, L * k)).astype(np.float32)).to(cuda)
    before = simhash.simhash.launches
    a = ops.simhash_fingerprint(x, r, L, k, impl="cuda")
    b = ops.simhash_fingerprint(x, r, L, k, impl="ref")
    assert simhash.simhash.launches == before + 1
    assert a.dtype == torch.int64 and a.shape == (n, L, (k + 31) // 32)
    assert not bool(a[0].any())
    simhash_flips(a, b, x, ops.pad_projection(r, L, k))


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(BUCKET_HASH_CASES))
def test_cuda_bucket_hash_matches_plain(cuda, name):
    """One launch a ``bucket_ids`` call; ids bit-equal to the plain path
    on the card and to the numpy uint32 version, and, on one projection,
    the kernel's front end equal to the plain chain after the matmul."""
    fam, params, x = bucket_hash_case(name, cuda)
    before = bucket_hash.bucket_hash.launches
    a = fam.bucket_ids(params, x, BUCKET_HASH_B)
    assert bucket_hash.bucket_hash.launches == before + 1
    b = fam.bucket_ids(params, x, BUCKET_HASH_B, impl="ref")
    assert bucket_hash.bucket_hash.launches == before + 1
    assert a.dtype == torch.int32 and torch.equal(a, b)
    np.testing.assert_array_equal(a.cpu().numpy(),
                                  np_bucket_ids(fam, params, x, BUCKET_HASH_B))
    if isinstance(fam, families.BitSampling):
        return
    proj = x.to(torch.float32) @ params["R" if fam.metric == "cosine" else "a"]
    if fam.metric == "cosine":
        got = bucket_hash.bucket_hash(proj, BUCKET_HASH_B, "sign", k=fam.k)
        words = families._pack_bits((proj > 0).reshape(-1, fam.L, fam.k))
    else:
        got = bucket_hash.bucket_hash(proj, BUCKET_HASH_B, "floor", k=fam.k,
                                      b=params["b"], w=fam.w)
        words = fam._floors(proj, params)
    assert torch.equal(got, families._mix_words_to_bucket(words,
                                                          BUCKET_HASH_B))


@pytest.mark.gpu
@pytest.mark.parametrize("front", ["sign", "floor"])
def test_cuda_bucket_hash_non_finite_and_out_of_range(cuda, front):
    """Projections of +-0, +-Inf, NaN, +-1e30 (past int64) and +-3e9 (past
    int32): the kernel's words are the plain chain's on the card, the
    float -> int64 conversion included."""
    L, k = 4, 9
    vals = torch.tensor([0.0, -0.0, float("inf"), float("-inf"), float("nan"),
                         1e30, -1e30, 3e9, -3e9, 2.5, -2.5, 1e-30],
                        dtype=torch.float32)
    proj = vals[torch.from_numpy(RNG.integers(0, len(vals), (64, L * k)))]
    proj = proj.contiguous().to(cuda)
    fam = families.PStableL1(d=1, L=L, k=k, w=0.7)
    params = {"b": torch.from_numpy(RNG.random(L * k).astype(np.float32)
                                    ).to(cuda)}
    if front == "sign":
        got = bucket_hash.bucket_hash(proj, BUCKET_HASH_B, "sign", k=k)
        words = families._pack_bits((proj > 0).reshape(-1, L, k))
    else:
        got = bucket_hash.bucket_hash(proj, BUCKET_HASH_B, "floor", k=k,
                                      b=params["b"], w=fam.w)
        words = fam._floors(proj, params)
    assert torch.equal(got, families._mix_words_to_bucket(words,
                                                          BUCKET_HASH_B))


@pytest.mark.gpu
@pytest.mark.parametrize("d,L,k,probes", MULTIPROBE_CASES)
def test_cuda_multiprobe_buckets_match_plain(cuda, d, L, k, probes):
    fam = families.SimHash(d=d, L=L, k=k)
    params = fam.init(torch.Generator().manual_seed(1), device=cuda)
    q = torch.from_numpy(RNG.normal(size=(1024, d)).astype(np.float32)).to(
        cuda)
    before = bucket_hash.bucket_hash.launches
    a = mp.probe_buckets(fam, params, q, probes, BUCKET_HASH_B)
    assert bucket_hash.bucket_hash.launches == before + 1
    b = mp.probe_buckets(fam, params, q, probes, BUCKET_HASH_B, impl="ref")
    assert a.shape == (1024, L, probes) and torch.equal(a, b)
    codes = mp.probe_codes(fam, params, q, probes).cpu().numpy()
    np.testing.assert_array_equal(
        a.cpu().numpy(), np_mix_words(codes.astype(np.uint32), BUCKET_HASH_B))


@pytest.mark.gpu
def test_cuda_streaming_pstable_hash_makes_no_sync(cuda):
    """A p-stable streaming index on the card: one bucket hash launch and
    one counted kernel hash a batch, 2 syncs a batch with one routed group
    (the route and the LSH group's indices; no divisor copy), one fewer
    than the same index on the plain path; the same collisions."""
    from repro_torch.core import CostModel
    from repro_torch.data import clustered_dataset, query_split
    from repro_torch.streaming import CompactionPolicy, DynamicHybridIndex
    x = clustered_dataset(16384, 54, n_clusters=16, dense_core_frac=0.05,
                          core_scale=0.05, seed=0, metric="l1")
    x, q = query_split(x, n_queries=256, seed=0)
    i, j = RNG.integers(0, len(x), (2, 2000))
    r = float(np.quantile(np.abs(x[i] - x[j]).sum(1), 0.12))
    fam = families.make_family("l1", d=54, L=20, r=r)

    def index(impl):
        return DynamicHybridIndex(
            fam, num_buckets=65536, m=64, cap=256, delta_capacity=8192,
            cost_model=CostModel(1.0, 10.0), seed=0, impl=impl,
            policy=CompactionPolicy(step_rows=8192), device=cuda).build(x)

    fast, plain = index(None), index("ref")
    before = bucket_hash.bucket_hash.launches
    for _ in range(3):
        a, b = fast.query(q, r), plain.query(q, r)
        assert len(a.lsh_idx) == len(q) and len(a.lin_idx) == 0
        assert torch.equal(a.route.collisions, b.route.collisions)
    assert bucket_hash.bucket_hash.launches == before + 3
    got, want = (i.index_stats()["query"] for i in (fast, plain))
    assert got == {"batches": 3, "syncs": 6, "hash_kernel_batches": 3,
                   "lsh_kernel_groups": 3}
    assert want == {"batches": 3, "syncs": 9, "hash_kernel_batches": 0,
                    "lsh_kernel_groups": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,L,k,view,inf_rows,mode", SIMHASH_CASES)
def test_cuda_simhash_edge_cases(cuda, n, d, L, k, view, inf_rows, mode):
    """Both loaders, offset views, d = 1, 3, 7 and 1,000, ragged tiles:
    one launch, bits as test_cuda_simhash_matches_plain allows; rows
    beside a row of +Inf match too (its own bits are NaN's or Inf's)."""
    x, r = simhash_inputs(n, d, L, k, view, inf_rows, RNG, cuda)
    assert simhash.plan(x, L, k)["mode"] == mode
    before = simhash.simhash.launches
    a = ops.simhash_fingerprint(x, r, L, k, impl="cuda")
    b = ops.simhash_fingerprint(x, r, L, k, impl="ref")
    assert simhash.simhash.launches == before + 1
    assert a.dtype == torch.int64 and a.shape == (n, L, (k + 31) // 32)
    assert not bool(a[0].any())
    keep = torch.ones(n, dtype=torch.bool, device=cuda)
    keep[list(inf_rows)] = False
    simhash_flips(a[keep], b[keep], x[keep], ops.pad_projection(r, L, k))


@pytest.mark.gpu
@pytest.mark.parametrize("metric,d", [("l2", 32), ("cosine", 254),
                                      ("l1", 54)])
def test_cuda_calibrate_runs_the_distance_kernel(cuda, metric, d):
    from repro_torch.core import calibrate
    kernel = distances.pairwise_l1 if metric == "l1" else distances.pairwise_dot
    before = kernel.launches
    cm = calibrate(d, metric, n_probe=1024)
    assert kernel.launches == before + 6      # one warm-up and 5 timed
    assert cm.alpha == 1.0 and np.isfinite(cm.beta) and cm.beta >= 1e-3


# ---------------------------------------------------------------------------
# checkpoints of card-resident state
# ---------------------------------------------------------------------------
def _churned_l1_index(device, seed=0):
    from repro_torch.core.lsh import make_family
    from repro_torch.streaming import CompactionPolicy, DynamicHybridIndex
    x = np.random.default_rng(seed).normal(size=(900, 16)).astype(np.float32)
    kw = dict(num_buckets=128, m=32, cap=512, delta_capacity=128,
              policy=CompactionPolicy(fanout=2))
    fam = make_family("l1", d=16, L=6, r=4.0)
    idx = DynamicHybridIndex(fam, seed=0, device=device, **kw).build(x[:500])
    idx.insert(x[500:860])
    idx.delete(list(range(0, 500, 7)) + list(range(840, 860)))
    return idx, x, fam, kw


@pytest.mark.gpu
def test_cuda_restore_puts_every_leaf_on_the_card(cuda, tmp_path):
    """``restore(template)`` (device "cuda" by default) returns every
    leaf as a tensor on the card, bfloat16 included, bit for bit."""
    from repro_torch.checkpoint import CheckpointManager
    g = torch.Generator().manual_seed(0)
    state = {"w": torch.randn(4, 8, generator=g).to(cuda),
             "h": torch.randn(3, generator=g).to(torch.bfloat16).to(cuda),
             "blocks": (torch.arange(5, device=cuda),
                        np.arange(3, dtype=np.int32)),
             "step": np.int64(7)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_incremental(1, state, blocking=True)
    restored, step = mgr.restore(state)
    assert step == 1
    leaves = [restored["w"], restored["h"], *restored["blocks"],
              restored["step"]]
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cuda"
               for t in leaves)
    assert torch.equal(restored["w"], state["w"])
    assert restored["h"].dtype == torch.bfloat16
    assert torch.equal(restored["h"].view(torch.int16),
                       state["h"].view(torch.int16))
    assert int(restored["step"]) == 7 and restored["step"].shape == ()


@pytest.mark.gpu
def test_cuda_churned_index_save_restore_same_sets(cuda, tmp_path):
    """A churned index saved from the card (inside a consistent cut,
    with the compaction driver running) and restored to the card
    reports the same sets on every route, with equal digests."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.streaming import CompactionDriver, DynamicHybridIndex
    idx, x, fam, kw = _churned_l1_index(cuda)
    drv = CompactionDriver(idx).start()
    mgr = CheckpointManager(str(tmp_path))
    drv.consistent_cut(lambda: mgr.save_index(1, idx, incremental=True,
                                              blocking=False))
    mgr.wait()
    drv.stop(flush=False)
    restored = DynamicHybridIndex(fam, seed=1, device=cuda, **kw)
    assert mgr.restore_index(restored) == 1
    assert restored.params["a"].device == idx.params["a"].device
    assert restored.state_digests() == idx.state_digests()
    q = x[::45]
    for force in (None, "lsh", "linear"):
        assert (restored.query(q, 9.0, force=force).neighbor_sets()
                == idx.query(q, 9.0, force=force).neighbor_sets()), force


@pytest.mark.gpu
def test_cuda_save_then_insert_writes_the_state_before_it(cuda, tmp_path):
    """The host copy happens before ``save_index`` returns: an in-place
    ``insert`` into the card's delta right after a non-blocking save
    does not reach the saved step."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.streaming import DynamicHybridIndex
    idx, x, fam, kw = _churned_l1_index(cuda)
    before = idx.state_dict()
    count = idx.delta.count
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_index(1, idx, incremental=True, blocking=False)
    idx.insert(x[860:880])                   # index_put_ into the delta
    assert idx.delta.count == count + 20
    mgr.wait()
    tree, _ = mgr.restore_tree()
    for leaf in ("x", "ids", "live", "bucket_ids", "count"):
        np.testing.assert_array_equal(tree["delta"][leaf],
                                      before["delta"][leaf], err_msg=leaf)
    restored = DynamicHybridIndex(fam, seed=1, device=cuda, **kw)
    mgr.restore_index(restored)
    assert restored.n == idx.n - 20 and restored.delta.count == count


@pytest.mark.gpu
def test_cuda_retrieval_service_matches_plain(cuda):
    """``RetrievalService`` at a reduced width (yi-6b, d_model 256) on
    the card: the kernels' reported sets on every path equal those of a
    plain (``impl="ref"``) index holding the same state, up to rows
    within 1e-5 * max(1, r) of the radius; removed ids never reported;
    LSH sets within linear sets; embeddings within 1e-4 of the CPU's
    from the same weights."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data import lm_batch
    from repro_torch.models import ParallelConfig, forward_embed, init_params
    from repro_torch.serve import RetrievalConfig, RetrievalService
    from repro_torch.streaming import DynamicHybridIndex
    cfg = reduced_config(get_config("yi-6b"), d_model=256, d_ff=512)
    cfg = dataclasses.replace(cfg, dtype="float32")
    par = ParallelConfig(attn_chunk_q=16, attn_chunk_k=16)
    svc = RetrievalService(cfg, par, init_params(cfg, seed=0, device=cuda),
                           RetrievalConfig(radius=0.5, tables=8,
                                           num_buckets=256, hll_m=32, cap=64,
                                           beta_over_alpha=1.0,
                                           delta_capacity=128),
                           device=cuda)

    def batch(seed, step, b=64):
        out = lm_batch(seed, step, batch=b, seq=12, vocab=cfg.vocab,
                       device=cuda)
        out.pop("labels")
        return out

    corpus = [batch(3, i) for i in range(4)]
    svc.index_corpus(corpus)
    new = svc.add_documents([batch(5, 0), batch(5, 1)])
    gone = list(range(0, 256, 7)) + new[::5].tolist()
    svc.remove_documents(gone)
    rows = {}
    for ids, b in [(range(i * 64, i * 64 + 64), c)
                   for i, c in enumerate(corpus)] + [
                       (new[:64], batch(5, 0)), (new[64:], batch(5, 1))]:
        rows.update(zip(np.asarray(ids).tolist(),
                        svc.embed(b).double().cpu().numpy()))
    cpu_params = copy.deepcopy(svc.params).to("cpu")
    np.testing.assert_allclose(
        forward_embed(cpu_params, corpus[0], cfg, par).numpy(),
        svc.embed(corpus[0]).cpu().numpy(), rtol=1e-4, atol=1e-4)
    qb = batch(4, 0)
    qb["tokens"][:8] = corpus[0]["tokens"][:8]
    res, emb = svc.query(qb)
    plain = DynamicHybridIndex(svc.index.family, params=svc.index.params,
                               impl="ref", num_buckets=256, m=32, cap=64,
                               delta_capacity=128,
                               device=cuda).load_state_dict(
                                   svc.index.state_dict())
    q64 = emb.double().cpu().numpy()

    def near(i, ids, what):
        for j in ids:
            d = 1.0 - q64[i] @ rows[j] / (np.linalg.norm(q64[i])
                                          * np.linalg.norm(rows[j]))
            assert abs(d - 0.5) <= 1e-5, (what, i, j, d)

    sets = {}
    for force in (None, "lsh", "linear"):
        a = svc.index.query(emb, 0.5, force=force).neighbor_sets()
        b = plain.query(emb, 0.5, force=force).neighbor_sets()
        for i in a:
            near(i, a[i] ^ b[i], force)
            assert not a[i] & set(gone), (force, i)
        sets[force] = a
    assert res.neighbor_sets() == sets[None]
    for i in sets["lsh"]:
        near(i, sets["lsh"][i] - sets["linear"][i], "lsh <= linear")
    assert 0 < len(res.lin_idx) < 64, len(res.lin_idx)
    assert sum(len(s) for s in sets[None].values()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("arch,remat,microbatch", TRAIN_CASES)
def test_cuda_train_step_matches_cpu(cuda, arch, remat, microbatch):
    """3 float32 train steps on the card and on the CPU from the same
    weights and batches, TF32 off (``torch_cases.train_device_vs_cpu``
    asserts its tolerances)."""
    train_device_vs_cpu(arch, remat, microbatch, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_cuda_prefill_decode_matches_cpu(cuda, arch):
    """Each layer kind's float32 prefill and decode steps on the card
    against the CPU, TF32 off (``torch_cases.serve_device_vs_cpu``
    asserts its tolerances)."""
    serve_device_vs_cpu(arch, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("scan,tail,n,chunk", SCAN_CASES)
def test_cuda_ssm_scan_matches_cpu(cuda, scan, tail, n, chunk):
    """The Mamba-1 and SSD chunk scans at Falcon-Mamba's and Zamba2's
    widths, 1 x 2,048 steps, on the card against the CPU."""
    scan_device_vs_cpu(scan, tail, n, chunk, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,mesh,kw", MESH_TRAIN_CASES)
def test_cuda_mesh_train_step_matches_cpu(cuda, arch, mesh, kw):
    """3 float32 train steps on a debug mesh of the card and of the CPU
    (the vocab-sharded loss; Granite-MoE's per-shard dispatch)."""
    train_device_vs_cpu(arch, "block", 1, cuda, mesh=mesh, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,mesh,kw", MESH_SERVE_CASES)
def test_cuda_mesh_prefill_decode_matches_cpu(cuda, arch, mesh, kw):
    """Float32 prefill and decode on a debug mesh of the card and of the
    CPU: the sequence-sharded decode over 'model' and over every axis,
    the KV-head layout, Granite-MoE's per-shard dispatch."""
    serve_device_vs_cpu(arch, cuda, mesh=mesh, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("site", MESH_SITES)
def test_cuda_mesh_site_matches_cpu(cuda, site):
    """Each per-shard site alone on the card against the CPU."""
    mesh_site_device_vs_cpu(site, cuda)



@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["yi-6b", "granite-moe-1b-a400m",
                                  "falcon-mamba-7b", "zamba2-1.2b"])
def test_cuda_cost_counter_matches_meta(cuda, arch):
    """``launch.hlo_analysis.analyze_step`` of one reduced train step and
    one prefill on the card against the same steps on the meta device:
    equal FLOPs (the model paths launch no hand-written kernel), bytes
    within 1 % (the same ATen ops; kept loose for an op that a device
    dispatches differently)."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data import lm_batch
    from repro_torch.launch.hlo_analysis import analyze_step
    from repro_torch.models import ParallelConfig
    from repro_torch.serve.engine import make_serve_prefill
    from repro_torch.train import init_state, make_train_step
    cfg = reduced_config(get_config(arch))
    par = ParallelConfig()
    counts = []
    for dev in (cuda, torch.device("meta")):
        state = init_state(cfg, 0, device=dev)
        batch = {k: (torch.empty(v.shape, dtype=v.dtype, device=dev)
                     if dev.type == "meta" else v.to(dev))
                 for k, v in lm_batch(0, 0, batch=2, seq=64, vocab=cfg.vocab,
                                      cfg=cfg, device="cpu").items()}
        train = analyze_step(make_train_step(cfg, par), state, batch)
        batch.pop("labels")
        with torch.inference_mode():
            pre = analyze_step(make_serve_prefill(cfg, par, 64),
                               state["params"], batch)
        counts.append((train, pre))
    for card, meta in zip(*counts):
        assert card.flops == meta.flops > 0
        assert abs(card.bytes - meta.bytes) <= 0.01 * meta.bytes
