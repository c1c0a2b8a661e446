"""The port's distance matrices, Hamming matrix, SimHash fingerprints and
``calibrate`` against ``repro``.

On the CPU the port's ``ops`` run the plain versions; they are held
against ``repro.kernels.ops`` under both ``impl="pallas_interpret"``
(the Pallas kernels in interpret mode) and ``impl="ref"`` (the jnp
oracles), case for case as ``tests/test_kernels.py`` holds the Pallas
kernels.  Distances are allclose at rtol = atol = 3e-4 (sums in other
orders), f16 inputs at 2e-3 (as the reference's own test); Hamming
distances and SimHash words are exact.

The CUDA kernels are held against the plain versions on a card by
``test_torch_gpu.py``.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import cost_model as tcost  # noqa: E402
from repro_torch.kernels import distances, hamming, simhash  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from torch_cases import TOL, simhash_packed_as_kernel  # noqa: E402

RNG = np.random.default_rng(0)
JAX_IMPLS = ["pallas_interpret", "ref"]


def _pts(n, d, dtype=np.float32):
    return RNG.normal(size=(n, d)).astype(dtype)


def _codes(n, w):
    return RNG.integers(0, 2**32, (n, w), dtype=np.uint32)


def _t(a):
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32 else a)


@pytest.mark.parametrize("jimpl", JAX_IMPLS)
@pytest.mark.parametrize("metric", ["l2", "l1", "cosine"])
@pytest.mark.parametrize("shape", [(8, 16, 7), (100, 130, 70),
                                   (128, 256, 128), (33, 257, 129)])
def test_pairwise_dist_matches_repro(jimpl, metric, shape):
    q, n, d = shape
    qa, xa = _pts(q, d), _pts(n, d)
    got = tops.pairwise_dist(_t(qa), _t(xa), metric)
    want = jops.pairwise_dist(jnp.asarray(qa), jnp.asarray(xa), metric,
                              impl=jimpl)
    assert got.dtype == torch.float32 and tuple(got.shape) == (q, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if metric == "l2":
        assert float(got.min()) >= 0.0


@pytest.mark.parametrize("jimpl", JAX_IMPLS)
@pytest.mark.parametrize("metric", ["l2", "l1", "cosine"])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_pairwise_dist_dtypes_match_repro(jimpl, metric, dtype):
    qa, xa = _pts(16, 32, dtype), _pts(64, 32, dtype)
    got = tops.pairwise_dist(_t(qa), _t(xa), metric)
    want = jops.pairwise_dist(jnp.asarray(qa), jnp.asarray(xa), metric,
                              impl=jimpl)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-3, atol=2e-3)


def test_pairwise_dist_zero_rows_and_unknown_metric():
    """An all-zero row: cosine's norm clamp (1e-12) gives distance 1."""
    qa, xa = _pts(5, 37), _pts(40, 37)
    qa[1] = 0.0
    xa[3] = 0.0
    for jimpl in JAX_IMPLS:
        got = tops.pairwise_dist(_t(qa), _t(xa), "cosine")
        want = jops.pairwise_dist(jnp.asarray(qa), jnp.asarray(xa), "cosine",
                                  impl=jimpl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert np.all(got.numpy()[1] == 1.0) and np.all(got.numpy()[:, 3] == 1.0)
    for metric in ("hamming", "l3"):
        with pytest.raises(ValueError):
            tops.pairwise_dist(_t(qa), _t(xa), metric)
        with pytest.raises(ValueError):
            jops.pairwise_dist(jnp.asarray(qa), jnp.asarray(xa), metric,
                               impl="ref")


@pytest.mark.parametrize("jimpl", JAX_IMPLS)
@pytest.mark.parametrize("shape", [(4, 10, 1), (60, 200, 2), (7, 50, 3),
                                   (128, 128, 8), (9, 70, 9), (5, 33, 16)])
def test_hamming_dist_matches_repro(jimpl, shape):
    q, n, w = shape
    qa, xa = _codes(q, w), _codes(n, w)
    qa[0] = 0
    xa[1] = 0
    got = tops.hamming_dist(_t(qa), _t(xa))
    want = jops.hamming_dist(jnp.asarray(qa), jnp.asarray(xa), impl=jimpl)
    assert got.dtype == torch.int32 and tuple(got.shape) == (q, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # int32 bit views count the same bits as the uint32 values
    views = tops.hamming_dist(torch.from_numpy(qa.view(np.int32)),
                              torch.from_numpy(xa.view(np.int32)))
    assert torch.equal(views, got)
    expect = np.stack([np.unpackbits((qa[i][None] ^ xa).view(np.uint8),
                                     axis=1).sum(1) for i in range(q)])
    np.testing.assert_array_equal(got.numpy(), expect)


@pytest.mark.parametrize("jimpl", JAX_IMPLS)
@pytest.mark.parametrize("L,k", [(3, 8), (5, 31), (2, 32), (4, 40), (1, 64)])
def test_simhash_fingerprint_matches_repro(jimpl, L, k):
    x, r = _pts(130, 48), _pts(48, L * k)
    got = tops.simhash_fingerprint(_t(x), _t(r), L=L, k=k)
    want = jops.simhash_fingerprint(jnp.asarray(x), jnp.asarray(r), L=L, k=k,
                                    impl=jimpl)
    words = (k + 31) // 32
    assert got.dtype == torch.int64 and tuple(got.shape) == (130, L, words)
    assert int(got.min()) >= 0 and int(got.max()) < 2**32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# the (L, k) cases of test_torch_gpu.py::test_cuda_simhash_matches_plain
SIMHASH_LK = [(3, 8), (5, 31), (2, 32), (4, 40), (1, 64), (20, 21), (7, 1),
              (20, 4), (3, 16)]


@pytest.mark.parametrize("jimpl", JAX_IMPLS)
@pytest.mark.parametrize("L,k", SIMHASH_LK)
def test_simhash_compact_projection_packs_the_fingerprint(jimpl, L, k):
    """The kernel's compact, permuted projection, projected and packed as
    its epilogue packs the ballots, is the fingerprint bit for bit."""
    x, r = _pts(130, 48), _pts(48, L * k)
    rp = tops.pad_projection(_t(r), L, k)
    lay = simhash.layout(L, k)
    rc = simhash.compact_projection(rp, L, k)
    assert rc.dtype == torch.float32 and rc.is_contiguous()
    assert tuple(rc.shape) == (lay.groups, 16 * lay.nfw, 48)
    got = simhash_packed_as_kernel(_t(x), rc, L, k)
    assert torch.equal(got, tref.simhash_fingerprint(_t(x), rp, L,
                                                     (k + 31) // 32))
    want = jops.simhash_fingerprint(jnp.asarray(x), jnp.asarray(r), L=L, k=k,
                                    impl=jimpl)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("L,k", SIMHASH_LK)
def test_simhash_compact_columns_hold_each_real_column_once(L, k):
    """Every real column of the padded projection appears once; the rest
    of a word's nibbles are its zero padding; a group fits 128 columns and
    a warp's half holds whole words."""
    lay = simhash.layout(L, k)
    cols = simhash.compact_columns(L, k)
    words = (k + 31) // 32
    real = {t * 32 + b for t in range(lay.tw)
            for b in range(min(32, k - 32 * (t % words)))}
    got = cols[cols >= 0].tolist()
    assert len(got) == len(set(got)) and real <= set(got)
    assert all(c % 32 < 4 * lay.npw and c // 32 < lay.tw for c in got)
    assert 1 <= lay.nfw <= 8 and 2 * lay.nfw >= lay.wh * lay.npw
    assert lay.groups * lay.wg >= lay.tw and 2 * lay.wh >= lay.wg


def test_simhash_layout_at_webspam_and_wide_words():
    """Webspam's L = 20, k = 4: 80 columns (not 640) in one group, 5
    fragments a warp's half; k = 21 takes 32 columns a word, 5 groups."""
    assert simhash.layout(20, 4) == simhash.Layout(1, 20, 10, 5, 1, 20)
    assert int((simhash.compact_columns(20, 4) >= 0).sum()) == 80
    assert simhash.layout(20, 21) == simhash.Layout(8, 4, 2, 8, 5, 20)


@pytest.mark.parametrize("k,want", [(1, 1), (2, 2), (3, 4), (4, 4), (5, 8),
                                    (16, 16), (17, 32), (32, 32), (40, 32)])
def test_simhash_lanes_per_word(k, want):
    """A word of a k-bit table takes the power of two at or above k lane
    columns of the kernel, and 32 past k = 16 or with two words."""
    assert simhash.lanes_per_word(k) == want


def test_simhash_bits_differing_allows_only_near_zero_projections():
    x, r = _t(_pts(40, 16)), _t(_pts(16, 2 * 32))
    a = tref.simhash_fingerprint(x, r, 2, 1)
    assert tref.simhash_bits_differing(a, a.clone(), x, r) == (0, 0)
    proj = (x.double() @ r.double()).abs()
    row, col = divmod(int(torch.argmax(proj)), proj.shape[1])
    b = a.clone()
    b[row, col // 32, 0] ^= 1 << (col % 32)
    assert tref.simhash_bits_differing(a, b, x, r) == (1, 1)
    x0 = x.clone()
    x0[row] = 0.0                 # every projection of this row is 0.0
    a0 = tref.simhash_fingerprint(x0, r, 2, 1)
    b0 = a0.clone()
    b0[row, col // 32, 0] ^= 1 << (col % 32)
    assert tref.simhash_bits_differing(a0, b0, x0, r) == (1, 0)


@pytest.mark.parametrize("L,k", [(3, 8), (4, 40), (2, 70)])
def test_pad_projection_matches_repro(L, k):
    r = _pts(11, L * k)
    got = tops.pad_projection(_t(r), L, k)
    want = jops.pad_projection(jnp.asarray(r), L, k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_simhash_fingerprint_matches_family_codes():
    """The fingerprints == ``SimHash.codes`` (the bucket codes) bit for
    bit, on the reference's own projections, in both packages."""
    from repro.core.lsh import SimHash as JSimHash
    from repro_torch.core.lsh import SimHash
    jfam = JSimHash(d=32, L=4, k=17)
    r = np.array(jfam.init(jax.random.PRNGKey(1))["R"])
    x = _pts(64, 32)
    fam = SimHash(d=32, L=4, k=17)
    codes = fam.codes({"R": _t(r)}, _t(x))
    got = tops.simhash_fingerprint(_t(x), _t(r), L=4, k=17)
    assert torch.equal(codes, got)
    want = jfam.codes({"R": jnp.asarray(r)}, jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_plain_simhash_and_hamming_match_repro_oracles():
    x, r = _pts(20, 9), _pts(9, 3 * 64)
    np.testing.assert_array_equal(
        tref.simhash_fingerprint(_t(x), _t(r), 3, 2).numpy(),
        np.asarray(jref.simhash_fingerprint(jnp.asarray(x), jnp.asarray(r),
                                            3, 2)))
    qa, xa = _codes(6, 9), _codes(30, 9)
    np.testing.assert_array_equal(
        tref.hamming(_t(qa), _t(xa)).numpy(),
        np.asarray(jref.hamming(jnp.asarray(qa), jnp.asarray(xa))))


@pytest.mark.parametrize("metric,d", [("l2", 32), ("cosine", 254),
                                      ("l1", 54)])
def test_calibrate_on_cpu(metric, d):
    before = (distances.pairwise_dot.launches,
              distances.pairwise_l1.launches)
    cm = tcost.calibrate(d, metric, n_probe=256, seed=3, device="cpu")
    assert cm.alpha == 1.0
    assert math.isfinite(cm.beta) and cm.beta >= 1e-3
    # the plain versions ran: no kernel launched on the CPU
    assert (distances.pairwise_dot.launches,
            distances.pairwise_l1.launches) == before


def test_calibrate_rejects_hamming_and_needs_cuda_by_default():
    from repro.core.cost_model import calibrate as jcalibrate
    from repro_torch.core import calibrate
    with pytest.raises(ValueError):
        calibrate(16, "hamming", n_probe=64, device="cpu")
    with pytest.raises(ValueError):
        jcalibrate(16, "hamming", n_probe=64)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            calibrate(16, "l2", n_probe=64)
        with pytest.raises(RuntimeError, match="CUDA"):
            calibrate(16, "l2", n_probe=64, device="cuda")


def test_time_fn_counts_one_warmup_and_the_timed_calls():
    calls = []
    sec = tcost._time_fn(lambda: calls.append(1), torch.device("cpu"),
                         iters=5)
    assert len(calls) == 6 and sec >= 0.0


def test_new_wrappers_launch_on_cuda_only():
    """impl="cuda" on CPU tensors raises, and so does each kernel wrapper
    called directly; no launch is counted."""
    qa, xa = _pts(4, 16), _pts(20, 16)
    qc, xc = _codes(4, 2), _codes(20, 2)
    r = _pts(16, 2 * 8)
    counters = (distances.pairwise_dot, distances.pairwise_l1,
                hamming.hamming, simhash.simhash)
    before = [fn.launches for fn in counters]
    for metric in ("l2", "l1", "cosine"):
        with pytest.raises(ValueError):
            tops.pairwise_dist(_t(qa), _t(xa), metric, impl="cuda")
    with pytest.raises(ValueError):
        tops.hamming_dist(_t(qc), _t(xc), impl="cuda")
    with pytest.raises(ValueError):
        tops.simhash_fingerprint(_t(xa), _t(r), L=2, k=8, impl="cuda")
    q32, x32 = (torch.from_numpy(a.view(np.int32)) for a in (qc, xc))
    with pytest.raises(ValueError, match="CUDA"):
        distances.pairwise_dot(_t(qa), _t(xa), _t(qa).sum(1), _t(xa).sum(1),
                               mode="l2")
    with pytest.raises(ValueError, match="CUDA"):
        distances.pairwise_l1(_t(qa), _t(xa))
    with pytest.raises(ValueError, match="CUDA"):
        hamming.hamming(q32, x32)
    with pytest.raises(ValueError, match="CUDA"):
        simhash.simhash(_t(xa), tops.pad_projection(_t(r), 2, 8), 2, 8)
    assert [fn.launches for fn in counters] == before
    # the plain version is forced on either device
    assert torch.equal(tops.hamming_dist(_t(qc), _t(xc), impl="ref"),
                       tref.hamming(_t(qc), _t(xc)))
