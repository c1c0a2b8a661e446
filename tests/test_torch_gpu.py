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


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["l2", "cosine"])
@pytest.mark.parametrize("q,n", [(8, 100), (33, 257), (65, 1000)])
def test_cuda_linear_scan_matches_plain(cuda, metric, q, n):
    qa, xa = pair(metric, q, n, RNG)
    qt, xt = as_tensor(qa).to(cuda), as_tensor(xa).to(cuda)
    before = fused_scan.linear_scan_dot.launches
    a = ops.fused_linear_scan(qt, xt, RADII[metric], metric, impl="cuda")
    b = ops.fused_linear_scan(qt, xt, RADII[metric], metric, impl="ref")
    assert fused_scan.linear_scan_dot.launches == before + 1
    np.testing.assert_array_equal(a[0].cpu().numpy(), b[0].cpu().numpy())
    np.testing.assert_array_equal(a[2].cpu().numpy(), b[2].cpu().numpy())
    np.testing.assert_allclose(a[1].cpu().numpy(), b[1].cpu().numpy(), **TOL)
    if metric == "cosine":      # unit rows made once by the caller
        c = ops.fused_linear_scan(qt, xt, RADII[metric], metric, impl="cuda",
                                  x_unit=unit_rows(xt).contiguous())
        assert all(torch.equal(u, v) for u, v in zip(a, c))


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["l1", "hamming"])
def test_cuda_linear_scan_waits_for_its_kernel(cuda, metric):
    qa, xa = pair(metric, 4, 20, RNG)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ops.fused_linear_scan(as_tensor(qa).to(cuda), as_tensor(xa).to(cuda),
                              RADII[metric], metric)


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
