"""The precision of the dot-form CUDA tile (K1 ``linear_scan_dot``, K6
``pairwise_dot``) and of the SimHash kernel (K9), emulated in numpy on
the CPU.

The tile multiplies on the tensor cores in TF32.  It splits each float32
input v into hi = tf32(v) and lo = tf32(v - hi), where tf32 is
``cvt.rna.tf32.f32`` (10 mantissa bits kept, the 13 dropped bits rounded
to nearest, ties away from zero), and accumulates lo.hi' + hi.lo' +
hi.hi' in float32, eight k at a time.  These tests emulate that
arithmetic on the Webspam (cosine, d = 254) and Corel (l2, d = 32)
analogues and hold every distance within 1e-5 * max(1, |t|) of float64
at the radii ``chip_smoke.py`` picks: the band inside which a reported
set may differ.  One TF32 pass does not stay inside it.  K9 makes the
same split in integer adds (the tensor cores ignore a TF32 operand's 13
low bits) and sums the same three passes: its projections of the Webspam
analogue stay within 1e-5 * sum_i |x_i r_i| of float64, the band inside
which a SimHash bit may differ.  No JAX, no card.
"""
import numpy as np
import pytest

from repro_torch.data.synthetic import paper_dataset, query_split

BAND = 1e-5
QUANTILES = (0.0005, 0.005, 0.03, 0.12)     # chip_smoke.pick_radii's
K_STEP = 8                                  # k of one mma.sync m16n8k8


def tf32_rna(v):
    """``cvt.rna.tf32.f32``: add half of the 13 dropped bits' unit to the
    magnitude's bits, then clear them (ties go away from zero)."""
    bits = np.asarray(v, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split_tf32(v):
    v = np.asarray(v, np.float32)
    hi = tf32_rna(v)
    return hi, tf32_rna(v - hi)


def dot_tf32(q, x, passes):
    """(Q, d) x (N, d) float32 -> (Q, N) float32 sums of the TF32
    products, accumulated in float32 in the tile's order: per 8-wide k
    step, the lo.hi' pass, the hi.lo' pass, then hi.hi' (``passes`` 3),
    or hi.hi' alone (``passes`` 1)."""
    qh, ql = split_tf32(q)
    xh, xl = split_tf32(x)
    terms = [(ql, xh), (qh, xl), (qh, xh)] if passes == 3 else [(qh, xh)]
    acc = np.zeros((q.shape[0], x.shape[0]), np.float32)
    for k0 in range(0, q.shape[1], K_STEP):
        for a, b in terms:
            for k in range(k0, min(k0 + K_STEP, q.shape[1])):
                # a product of two TF32 values is exact in float32
                acc += np.multiply.outer(a[:, k], b[:, k])
    return acc


def unit_rows(v):
    """float32 rows scaled to unit norm, as ``ref.unit_rows``."""
    v = np.asarray(v, np.float32)
    n = np.sqrt((v * v).sum(1, keepdims=True, dtype=np.float32))
    return v / np.maximum(n, np.float32(1e-12))


def pick_radii(x, metric, seed=0):
    rng = np.random.default_rng(seed)
    a = x[rng.integers(0, len(x), 2000)].astype(np.float64)
    b = x[rng.integers(0, len(x), 2000)].astype(np.float64)
    if metric == "l2":
        d = np.linalg.norm(a - b, axis=1)
    else:
        d = 1.0 - (a * b).sum(1) / np.maximum(
            np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1), 1e-9)
    return [float(r) for r in np.quantile(d, QUANTILES)]


@pytest.fixture(scope="module")
def emulated():
    """name -> (metric, thresholds, float64 distances, {passes: the
    emulated kernel's distances}) on 32 queries x 4,000 rows."""
    out = {}
    for name in ("webspam", "corel"):
        x, metric = paper_dataset(name, scale=4100 / {"webspam": 350000,
                                                      "corel": 68040}[name],
                                  seed=0)
        x, q = query_split(x, n_queries=32, seed=0)
        x = x[:4000]
        radii = pick_radii(x, metric)
        q64, x64 = q.astype(np.float64), x.astype(np.float64)
        if metric == "l2":
            want = ((q64[:, None, :] - x64[None, :, :]) ** 2).sum(-1)
            qn = (q * q).sum(1, dtype=np.float32)
            xn = (x * x).sum(1, dtype=np.float32)
            got = {p: np.maximum((qn[:, None] + xn[None, :])
                                 - np.float32(2) * dot_tf32(q, x, p),
                                 np.float32(0)) for p in (1, 3)}
            thresholds = [r * r for r in radii]
        else:
            qu = q64 / np.linalg.norm(q64, axis=1, keepdims=True)
            xu = x64 / np.linalg.norm(x64, axis=1, keepdims=True)
            want = 1.0 - qu @ xu.T
            got = {p: np.float32(1) - dot_tf32(unit_rows(q), unit_rows(x), p)
                   for p in (1, 3)}
            thresholds = radii
        out[name] = (metric, thresholds, want, got)
    return out


@pytest.mark.parametrize("name", ["webspam", "corel"])
@pytest.mark.parametrize("qi", range(len(QUANTILES)))
def test_three_tf32_passes_stay_in_the_band(emulated, name, qi):
    metric, thresholds, want, got = emulated[name]
    t = thresholds[qi]
    err = np.abs(got[3].astype(np.float64) - want).max()
    assert err <= BAND * max(1.0, abs(t)), (name, metric, t, err)


@pytest.mark.parametrize("name", ["webspam", "corel"])
@pytest.mark.parametrize("qi", range(len(QUANTILES)))
def test_one_tf32_pass_leaves_the_band(emulated, name, qi):
    metric, thresholds, want, got = emulated[name]
    t = thresholds[qi]
    err = np.abs(got[1].astype(np.float64) - want).max()
    assert err > BAND * max(1.0, abs(t)), (name, metric, t, err)


@pytest.mark.parametrize("v,want", [
    (1.0, 1.0),
    (1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10),          # representable
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),          # a tie: away from 0
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 2.0 ** -11 - 2.0 ** -23, 1.0),          # below the tie
    (2.0 - 2.0 ** -23, 2.0),                       # carries into the exponent
    (0.0, 0.0),
])
def test_tf32_rna_rounds_to_nearest_ties_away(v, want):
    assert float(tf32_rna(np.float32(v))) == want


def test_split_reconstructs_to_2_pow_minus_22():
    v = np.random.default_rng(0).normal(size=100_000).astype(np.float32)
    hi, lo = split_tf32(v)
    assert not (hi.view(np.uint32) & 0x1FFF).any()
    assert not (lo.view(np.uint32) & 0x1FFF).any()
    rest = v.astype(np.float64) - hi.astype(np.float64) - lo.astype(np.float64)
    assert (np.abs(rest) <= 2.0 ** -22 * np.abs(v)).all()


def k9_split(v):
    """``simhash.cu``'s split_tf32 as the tensor cores read it: hi's bits
    plus half the unit of the 13 dropped bits, lo the same of v - hi's
    value; each operand's 13 low bits ignored."""
    bits = np.asarray(v, np.float32).view(np.uint32)
    mask = np.uint32(0xFFFFE000)
    hi = (bits + np.uint32(0x1000)) & mask
    rest = (np.asarray(v, np.float32) - hi.view(np.float32)).view(np.uint32)
    return hi.view(np.float32), ((rest + np.uint32(0x1000)) & mask).view(np.float32)


def test_k9_integer_split_is_the_tile_split():
    v = np.random.default_rng(1).normal(size=100_000).astype(np.float32)
    v[:7] = [0.0, -0.0, 1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 2.0 - 2.0 ** -23,
             1e-30, -3.5e20]
    for got, want in zip(k9_split(v), split_tf32(v)):
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.fixture(scope="module")
def simhash_emulated():
    """(float64 projections, sum_i |x_i r_i|, {passes: the emulated
    kernel's projections}) of 4,000 Webspam-analogue rows onto 80
    Gaussian hyperplanes (L = 20, k = 4)."""
    x, _ = paper_dataset("webspam", scale=4100 / 350000, seed=0)
    x = x[:4000]
    r = np.random.default_rng(1).normal(size=(x.shape[1], 80)).astype(np.float32)
    x64, r64 = x.astype(np.float64), r.astype(np.float64)
    return (x64 @ r64, np.abs(x64) @ np.abs(r64),
            {p: dot_tf32(x, np.ascontiguousarray(r.T), p) for p in (1, 3)})


@pytest.mark.parametrize("passes,inside", [(3, True), (1, False)])
def test_simhash_projections_and_the_band(simhash_emulated, passes, inside):
    want, scale, got = simhash_emulated
    err = (np.abs(got[passes].astype(np.float64) - want) / scale).max()
    assert (err <= BAND) == inside, (passes, err)
