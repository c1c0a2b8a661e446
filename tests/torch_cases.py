"""Inputs shared by the port's kernel tests (numpy and torch only, so the
GPU tests run where JAX is not installed)."""
import numpy as np
import torch

RADII = {"l2": 7.0, "l1": 55.0, "cosine": 0.9, "hamming": 300.0}
TOL = dict(rtol=3e-4, atol=3e-4)   # distances: sums in different orders


def pair(metric, q, n, rng):
    """numpy (queries, corpus): float32 rows, or uint32 packed codes."""
    if metric == "hamming":
        return (rng.integers(0, 2**32, (q, 3), dtype=np.uint32),
                rng.integers(0, 2**32, (n, 3), dtype=np.uint32))
    return (rng.normal(size=(q, 37)).astype(np.float32),
            rng.normal(size=(n, 37)).astype(np.float32))


def as_tensor(a):
    """numpy -> CPU tensor (uint32 codes as int64 holding the values)."""
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32 else a)


def handcrafted_ids(n):
    """Sorted candidates: duplicate runs, a sentinel tail, an empty row."""
    sent = n
    ids = np.array([
        [0, 0, 0, 1, 2, 2, 5, sent],
        [3, 7, 7, 9, sent, sent, sent, sent],
        [sent] * 8,
    ], np.int32)
    return np.sort(ids, axis=-1)


def hll_regs(q, L, m, kind, rng):
    """uint8 registers: random, small-range (mostly empty) or large-range
    (the 2^32 correction)."""
    if kind == "random":
        return rng.integers(0, 25, (q, L, m)).astype(np.uint8)
    if kind == "small":
        r = np.zeros((q, L, m), np.uint8)
        r[:, 0, : m // 8] = 2
        return r
    lo = 29 - int(np.log2(m))
    return rng.integers(lo, lo + 2, (q, L, m)).astype(np.uint8)


def simhash_flips(a, b, x, r_padded):
    """Count the bits where the packed fingerprints ``a`` and ``b``
    ((N, L, words)) differ; raise unless every such bit's float64
    projection lies near 0 (``ref.simhash_bits_differing``)."""
    from repro_torch.kernels.ref import simhash_bits_differing
    differ, far = simhash_bits_differing(a, b, x, r_padded)
    assert far == 0, f"{far} bits differ away from 0"
    return differ


# (Q, N, d, view) for the dot-form tile (K1, K6): Q across n-fragments and
# query groups, N = 1 and ragged row tiles, d through each copy width (4 B:
# 1, 3, 37; 8 B: 54, 254; 16 B: 32, 256) and a ragged d-chunk, queries
# staged in two d-panels (65 x 16,897 x 384: 128 query rows of 388 words
# do not fit beside the ring), the corpus as x[1:] of an odd-d corpus
# ("rows") or 4 bytes into its buffer ("flat").
DOT_CASES = [(1, 1, 1, None), (8, 100, 37, None), (25, 129, 3, None),
             (32, 1000, 32, None), (33, 257, 256, None), (100, 333, 54, None),
             (129, 515, 254, None), (1, 300, 254, None), (100, 1, 32, None),
             (7, 300, 1, None), (129, 64, 3, None), (32, 4097, 254, None),
             (65, 16897, 384, None), (33, 257, 37, "rows"),
             (32, 300, 32, "flat"), (25, 129, 54, "flat")]
THRESH_EPS = 1e-5      # reported sets may differ within this of t (relative)


def dot_inputs(metric, q, n, d, rng):
    """float32 (q, d) queries and (n, d) rows: query 0 and the last row
    all zero (where there are two), rows 0-7 placed within 1e-4 of the
    threshold t of the last query.  Returns (queries, rows, t); t is the
    raw threshold (r for cosine, r^2 for l2)."""
    qa = rng.normal(size=(q, d)).astype(np.float32)
    xa = rng.normal(size=(n, d)).astype(np.float32)
    t = 0.9 if metric == "cosine" else 2.0 * d
    if q > 1:
        qa[0] = 0.0
    xa[-1] = 0.0
    u = qa[-1].astype(np.float64)
    for i in range(min(8, n - 1) if metric == "l2" or d > 1 else 0):
        w = rng.normal(size=d)
        dt = rng.uniform(-1e-4, 1e-4)
        if metric == "cosine":      # at angle arccos(1 - t - dt) from u
            un = u / np.linalg.norm(u)
            w -= (w @ un) * un
            c = 1.0 - t - dt
            xa[i] = (c * un + np.sqrt(1 - c * c) * w / np.linalg.norm(w)) \
                * rng.uniform(0.5, 2.0)
        else:                       # at distance sqrt(t + dt) from u
            xa[i] = u + np.sqrt(t + dt) * w / np.linalg.norm(w)
    return qa, xa, t


def unit_rows_np(a):
    """float32 rows scaled to unit norm (norms clamped at 1e-12)."""
    return (a / np.maximum(np.linalg.norm(a, axis=1, keepdims=True),
                           1e-12)).astype(np.float32)


def on_device(a, view, device):
    """numpy ``a`` on ``device``: as it is, as x[1:] of one more row
    ("rows"), or starting 4 bytes into its buffer ("flat")."""
    if view == "rows":
        a = np.concatenate([np.zeros((1, a.shape[1]), np.float32), a])
        return torch.from_numpy(a).to(device)[1:]
    if view == "flat":
        buf = np.zeros(a.size + 1, np.float32)
        buf[1:] = a.ravel()
        return torch.from_numpy(buf).to(device)[1:].view(a.shape)
    return torch.from_numpy(a).to(device)


def dist64(metric, q, x):
    """(Q, N) float64 squared-l2 or cosine distances (norms clamped)."""
    q, x = q.astype(np.float64), x.astype(np.float64)
    if metric == "l2":
        return np.maximum((q * q).sum(1)[:, None] + (x * x).sum(1)[None, :]
                          - 2.0 * q @ x.T, 0.0)
    qn = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    xn = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
    return 1.0 - qn @ xn.T


def masks_outside_band_agree(mask, mask_plain, d64, t):
    """Report masks may differ from the plain version's, and from the
    float64 distance's, only within THRESH_EPS * max(1, |t|) of t."""
    near = np.abs(d64 - t) <= THRESH_EPS * max(1.0, abs(t))
    assert not ((mask != mask_plain) & ~near).any(), "masks differ off t"
    assert not ((mask != (d64 <= t)) & ~near).any(), "masks wrong off t"
