"""Parity of ``repro_torch.core.hll`` with ``repro.core.hll`` on the CPU."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import hll as jhll  # noqa: E402
from repro_torch.core import hll as thll  # noqa: E402

RNG = np.random.default_rng(0)


def _ids():
    """Random ids, ids near 2^31 and 2^32 boundaries, and small ids."""
    edge = np.array([0, 1, 2**31 - 2, 2**31 - 1, 2**31, 2**31 + 1,
                     2**32 - 2, 2**32 - 1], np.uint64)
    rand = RNG.integers(0, 2**32, 5000, dtype=np.uint64)
    return np.concatenate([edge, rand, np.arange(3000, dtype=np.uint64)])


@pytest.mark.parametrize("seed", [0, 17, 123456])
def test_hash32_bit_identical(seed):
    ids = _ids().astype(np.uint32)
    want = np.asarray(jhll.hash32(jnp.asarray(ids), seed)).astype(np.int64)
    got = thll.hash32(torch.from_numpy(ids.astype(np.int64)), seed).numpy()
    np.testing.assert_array_equal(got, want)


def test_hash32_int32_input_near_2_31():
    """Signed int32 ids (as the tables carry them) hash like their uint32
    bit patterns in both packages."""
    ids = np.array([2**31 - 1, 2**31 - 2, -1, -(2**31), 0, 7], np.int32)
    want = np.asarray(jhll.hash32(jnp.asarray(ids))).astype(np.int64)
    got = thll.hash32(torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, want)


def test_clz32_bit_identical():
    x = np.concatenate([np.array([0, 1, 2, 3, 2**31, 2**32 - 1, 0xFFFF,
                                  0x10000], np.uint64),
                        np.uint64(1) << np.arange(32, dtype=np.uint64),
                        RNG.integers(0, 2**32, 4000, dtype=np.uint64)])
    want = np.asarray(jhll.clz32(jnp.asarray(x.astype(np.uint32))))
    got = thll.clz32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m", [16, 64, 128])
def test_point_register_rank_bit_identical(m):
    ids = _ids().astype(np.int64) % (2**31)
    jr, jk = jhll.point_register_rank(jnp.asarray(ids.astype(np.int32)), m)
    tr, tk = thll.point_register_rank(torch.from_numpy(ids), m)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


@pytest.mark.parametrize("n,B,m", [(2048, 64, 64), (500, 8, 16),
                                   (1000, 256, 32)])
def test_build_bucket_hlls_bit_identical(n, B, m):
    ids = np.arange(n, dtype=np.int32)
    ids[-4:] = [2**31 - 1, 2**31 - 2, 2**31 - 3, 2**31 - 4]
    bids = RNG.integers(0, B, n).astype(np.int32)
    want = np.asarray(jhll.build_bucket_hlls(jnp.asarray(ids),
                                             jnp.asarray(bids), B, m))
    got = thll.build_bucket_hlls(torch.from_numpy(ids),
                                 torch.from_numpy(bids), B, m).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 0).any() and got.max() > 1


def _registers(kind, m):
    if kind == "empty":
        return np.zeros((4, m), np.int32)
    if kind == "small":        # few set registers: linear counting
        r = np.zeros((4, m), np.int32)
        r[:, : m // 8] = RNG.integers(1, 4, (4, m // 8))
        return r
    if kind == "mid":          # no zero registers: the raw estimator
        return RNG.integers(3, 9, (4, m)).astype(np.int32)
    if kind == "saturated":    # 2^32 large-range correction (est < 2^32)
        lo = 29 - int(np.log2(m))
        return RNG.integers(lo, lo + 2, (4, m)).astype(np.int32)
    raise ValueError(kind)


def _estimate_f64(regs, m):
    """The estimator in float64 with exact powers of two."""
    r = regs.astype(np.float64)
    raw = thll._alpha(m) * m * m / np.sum(2.0 ** -r, axis=-1)
    zeros = np.sum(regs == 0, axis=-1).astype(np.float64)
    small = m * np.log(m / np.maximum(zeros, 1e-9))
    est = np.where((raw <= 2.5 * m) & (zeros > 0), small, raw)
    return np.where(est > 2.0**32 / 30, -2.0**32 * np.log1p(-est / 2.0**32),
                    est)


@pytest.mark.parametrize("kind", ["empty", "small", "mid", "saturated"])
@pytest.mark.parametrize("m", [16, 64, 256])
def test_estimate_cardinality_matches(kind, m):
    regs = _registers(kind, m)
    want = np.asarray(jhll.estimate_cardinality(jnp.asarray(regs), m))
    got = thll.estimate_cardinality(torch.from_numpy(regs), m).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, _estimate_f64(regs, m), rtol=1e-6)
    rtol = 1e-6
    if kind == "saturated":
        assert (want > 2**32 / 30).all()
        # XLA's CPU exp2 is inexact for integer arguments >= 13 (up to
        # 1.01e-6 relative at 26), so the reference itself sits ~1e-6 off
        # the exact estimate here; the port's exp2 is exact.
        r = np.arange(13, 34, dtype=np.float32)
        assert (np.asarray(jnp.exp2(-jnp.asarray(r))) != 2.0 ** -r).any()
        rtol = 2e-6
    np.testing.assert_allclose(got, want, rtol=rtol)


def test_merge_and_relative_error():
    regs = RNG.integers(0, 20, (5, 6, 32)).astype(np.int32)
    np.testing.assert_array_equal(
        thll.merge_registers(torch.from_numpy(regs), axis=1).numpy(),
        np.asarray(jhll.merge_registers(jnp.asarray(regs), axis=1)))
    np.testing.assert_allclose(
        thll.estimate_from_registers(torch.from_numpy(regs[:, 0])).numpy(),
        np.asarray(jhll.estimate_from_registers(jnp.asarray(regs[:, 0]))),
        rtol=1e-6)
    assert thll.relative_error(64) == jhll.relative_error(64)
