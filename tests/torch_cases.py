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
