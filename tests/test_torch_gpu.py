"""The CUDA kernels against their plain PyTorch versions, on a card.

Imports neither JAX nor ``repro``, so it runs on a GPU machine without
them:  ``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.
Every test skips (with its reason) where there is no CUDA device: the
kernels have no CPU mode.  Tolerances as in ``test_torch_kernels.py``;
HLL estimates at rtol 1e-5 (float32 sums in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import fused_scan, hll_merge, ops  # noqa: E402
from repro_torch.kernels.ref import unit_rows  # noqa: E402
from torch_cases import (RADII, TOL, as_tensor, handcrafted_ids,  # noqa: E402
                         hll_regs, pair)

RNG = np.random.default_rng(0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


LINEAR_KERNEL = {"l2": "linear_scan_dot", "cosine": "linear_scan_dot",
                 "l1": "linear_scan_l1", "hamming": "linear_scan_hamming"}


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["l2", "cosine", "l1", "hamming"])
@pytest.mark.parametrize("q,n", [(8, 100), (33, 257), (65, 1000)])
def test_cuda_linear_scan_matches_plain(cuda, metric, q, n):
    qa, xa = pair(metric, q, n, RNG)
    qt, xt = as_tensor(qa).to(cuda), as_tensor(xa).to(cuda)
    kernel = getattr(fused_scan, LINEAR_KERNEL[metric])
    before = kernel.launches
    a = ops.fused_linear_scan(qt, xt, RADII[metric], metric, impl="cuda")
    b = ops.fused_linear_scan(qt, xt, RADII[metric], metric, impl="ref")
    assert kernel.launches == before + 1
    np.testing.assert_array_equal(a[0].cpu().numpy(), b[0].cpu().numpy())
    np.testing.assert_array_equal(a[2].cpu().numpy(), b[2].cpu().numpy())
    np.testing.assert_allclose(a[1].cpu().numpy(), b[1].cpu().numpy(), **TOL)
    if metric == "cosine":      # unit rows made once by the caller
        c = ops.fused_linear_scan(qt, xt, RADII[metric], metric, impl="cuda",
                                  x_unit=unit_rows(xt).contiguous())
        assert all(torch.equal(u, v) for u, v in zip(a, c))


@pytest.mark.gpu
@pytest.mark.parametrize("w", [1, 2, 3, 8])
def test_cuda_hamming_scan_words_zero_codes_and_ties(cuda, w):
    """W = 1..8 words, all-zero codes, and a threshold equal to an
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


@pytest.mark.gpu
def test_cuda_index_default_device(cuda):
    from repro_torch.core import HybridLSHIndex
    from repro_torch.core.lsh import make_family
    x = RNG.normal(size=(500, 16)).astype(np.float32)
    idx = HybridLSHIndex(make_family("l2", d=16, L=4, r=2.0),
                         num_buckets=64).build(x)
    assert idx.x.is_cuda and idx.tables.perm.is_cuda
    before = hll_merge.hll_merge_estimate.launches
    res = idx.query(x[:20], 2.0)
    assert hll_merge.hll_merge_estimate.launches == before + 1
    for i in range(20):
        assert i in res.neighbors(i)


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["l1", "hamming"])
def test_cuda_churned_dynamic_index_matches_plain(cuda, metric):
    """A small churned DynamicHybridIndex (freezes, a merge, deletes in
    segments and the delta) through the kernels and through the plain
    versions reports the same sets on every route."""
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
    for force in (None, "lsh", "linear"):
        before = kernel.launches
        a = idx.query(q, r, force=force)
        assert kernel.launches > before       # the delta scan, at least
        b = plain.query(q, r, force=force)
        assert a.neighbor_sets() == b.neighbor_sets(), force
