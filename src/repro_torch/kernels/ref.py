"""Plain PyTorch versions of every kernel in this package.

These are the correctness references that the CUDA kernels are held
against (on the card, by ``chip_smoke.py`` and the ``gpu`` tests) AND
the CPU execution path: for a tensor on the CPU the ``ops`` layer runs
these, for a CUDA tensor it launches the kernels.  Each mirrors the jnp
oracle of the same name in ``repro.kernels.ref``.

Packed 32-bit codes (Hamming) may arrive as int32 bit views or as int64
tensors holding uint32 values; both are read through ``as_u32``.
"""
from __future__ import annotations

import torch

from repro_torch.u32 import MASK32, as_u32


def popcount_u32(v: torch.Tensor) -> torch.Tensor:
    """Classic SWAR popcount of 32-bit values -> int32."""
    v = as_u32(v)
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & MASK32) >> 24).to(torch.int32)


def pairwise_sql2(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances, (Q, d) x (N, d) -> (Q, N) float32, in the
    form the linear-scan kernel tiles: ||q||^2 + ||x||^2 - 2<q,x>."""
    q = q.to(torch.float32)
    x = x.to(torch.float32)
    qn = torch.sum(q * q, dim=-1)
    xn = torch.sum(x * x, dim=-1)
    d = qn[:, None] + xn[None, :] - 2.0 * (q @ x.T)
    return torch.clamp(d, min=0.0)


L1_BLOCK_ELEMS = 1 << 24   # floats in one block of pairwise_l1's difference


def pairwise_l1(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """L1 distances, (Q, d) x (N, d) -> (Q, N) float32.

    Works over N in blocks so the (Q, rows, d) difference it sums holds
    at most about ``L1_BLOCK_ELEMS`` floats (64 MB), not Q x N x d of
    them (3.6 GB for 32 queries over 524,288 rows of 54); each distance
    is the same sum over d either way.
    """
    q = q.to(torch.float32)
    x = x.to(torch.float32)
    nq, d = q.shape
    out = torch.empty((nq, x.shape[0]), dtype=torch.float32, device=q.device)
    step = max(1, L1_BLOCK_ELEMS // max(nq * d, 1))
    for lo in range(0, x.shape[0], step):
        out[:, lo:lo + step] = torch.sum(
            torch.abs(q[:, None, :] - x[None, lo:lo + step, :]), dim=-1)
    return out


def unit_rows(v: torch.Tensor) -> torch.Tensor:
    """Rows scaled to unit L2 norm (norms clamped at 1e-12)."""
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=1e-12)


def pairwise_cosine(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Cosine distances 1 - cos(q, x), (Q, d) x (N, d) -> (Q, N)."""
    return 1.0 - unit_rows(q.to(torch.float32)) \
        @ unit_rows(x.to(torch.float32)).T


def rowwise_dist(rows: torch.Tensor, q: torch.Tensor,
                 metric: str) -> torch.Tensor:
    """rows: (..., C, d) candidates vs q: (..., d) -> (..., C) distances.

    The candidate-verification math; L2 returns squared distance,
    consistent with ``pairwise_sql2``.  The LSH-scan kernel computes the
    same per-row expression.
    """
    if metric == "hamming":
        x = as_u32(rows) ^ as_u32(q)[..., None, :]
        return torch.sum(popcount_u32(x), dim=-1).to(torch.float32)
    rows = rows.to(torch.float32)
    q = q.to(torch.float32)[..., None, :]
    if metric == "l2":
        d = rows - q
        return torch.sum(d * d, dim=-1)
    if metric == "l1":
        return torch.sum(torch.abs(rows - q), dim=-1)
    if metric == "cosine":
        return 1.0 - torch.sum(unit_rows(rows) * unit_rows(q), dim=-1)
    raise ValueError(metric)


def hamming(qc: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
    """Hamming distances over packed codes, (Q, W) x (N, W) -> (Q, N) i32."""
    x = as_u32(qc)[:, None, :] ^ as_u32(xc)[None, :, :]
    return torch.sum(popcount_u32(x), dim=-1, dtype=torch.int32)


def fused_linear_scan(q: torch.Tensor, x: torch.Tensor, thresh,
                      metric: str):
    """The composed linear-route pipeline (pairwise distance ->
    threshold -> broadcast ids).  Returns (ids, dists, mask), each
    (Q, N); ``thresh`` is already radius-transformed (r^2 for l2)."""
    if metric == "hamming":
        dists = hamming(q, x).to(torch.float32)
    elif metric == "l2":
        dists = pairwise_sql2(q, x)
    elif metric == "l1":
        dists = pairwise_l1(q, x)
    elif metric == "cosine":
        dists = pairwise_cosine(q, x)
    else:
        raise ValueError(metric)
    mask = dists <= thresh
    ids = torch.arange(x.shape[0], dtype=torch.int32,
                       device=x.device).expand(dists.shape)
    return ids, dists, mask


def fused_lsh_scan(x: torch.Tensor, ids_sorted: torch.Tensor,
                   prev: torch.Tensor, q: torch.Tensor, thresh,
                   metric: str):
    """The composed LSH-route pipeline: sorted-run dedup -> row gather
    -> rowwise distance -> threshold.

    ids_sorted: (Q, C) sorted candidate ids with sentinel = x.shape[0];
    prev: ids_sorted shifted right one slot (prev[..., 0] = -1), so
    ``ids != prev`` marks run starts.  Returns (ids_sorted, dists, mask),
    each (Q, C).
    """
    n = x.shape[0]
    uniq = (ids_sorted != prev) & (ids_sorted < n)
    rows = x[ids_sorted.to(torch.int64).clamp(0, n - 1)]   # (Q, C, d)
    dists = rowwise_dist(rows, q, metric)
    mask = uniq & (dists <= thresh)
    return ids_sorted, dists, mask


def hll_merge_estimate(regs: torch.Tensor) -> torch.Tensor:
    """Merge (Q, L, m) registers over L and estimate cardinality -> (Q,)
    float32, exactly as ``core.hll`` does."""
    from repro_torch.core import hll as hll_lib   # core imports kernels
    merged = hll_lib.merge_registers(regs.to(torch.int32), axis=1)
    return hll_lib.estimate_cardinality(merged, int(regs.shape[-1]))
