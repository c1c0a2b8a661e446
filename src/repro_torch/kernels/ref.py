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

from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.u32 import MASK32, as_u32

EXT_SENTINEL = 2**31 - 1   # masked-out slots in reported buffers


class TableTerms(NamedTuple):
    """What the route estimate reads of one frozen segment."""

    starts: torch.Tensor                  # (L, B + 1) int32 CSR offsets
    registers: torch.Tensor               # (L, B, m) uint8 per-bucket HLLs
    tomb_counts: Optional[torch.Tensor]   # (L, B) int32 dead counts, or None


class ScanPart(NamedTuple):
    """One segment of a grouped linear scan."""

    x: torch.Tensor                       # (n, d) rows, or (n, W) codes
    live: Optional[torch.Tensor] = None   # (>= n,) bool, or None: all live
    ext: Optional[torch.Tensor] = None    # (>= n,) int32 ids, or None: row index
    x_unit: Optional[torch.Tensor] = None  # cosine: x's unit rows, for K1


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


def simhash_fingerprint(x: torch.Tensor, r_padded: torch.Tensor, L: int,
                        words: int) -> torch.Tensor:
    """SimHash fingerprints, (N, d) x (d, L*words*32) -> (N, L, words)
    packed words (int64 holding [0, 2**32), as ``families._pack_bits``).

    ``r_padded`` has zero columns beyond the family's true k bits per
    table (zero projection -> bit 0); bit j of a word is its column j.
    """
    proj = x.to(torch.float32) @ r_padded.to(torch.float32)
    bits = (proj > 0).reshape(x.shape[0], L, words, 32).to(torch.int64)
    return torch.sum(bits << torch.arange(32, device=x.device), dim=-1)


# relative to sum_i |x_i r_i|: float32 sums in other orders
SIMHASH_EPS = 1e-5


def simhash_bits_differing(a: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                           r_padded: torch.Tensor, eps: float = SIMHASH_EPS):
    """Compare packed fingerprints ``a`` and ``b`` ((N, L, words)) of the
    points ``x`` under ``r_padded``.  Returns (bits that differ, those of
    them whose float64 projection lies farther than eps * sum_i |x_i r_i|
    from 0).  Two correct float32 projections may differ only in the first
    count: the second must be 0."""
    n = a.shape[0]
    diff = (a.to(torch.int64) ^ b.to(torch.int64)).reshape(n, -1) & 0xFFFFFFFF
    rows, words = torch.nonzero(diff, as_tuple=True)
    if len(rows) == 0:
        return 0, 0
    bits = (diff[rows, words][:, None]
            >> torch.arange(32, device=diff.device)) & 1
    hit, bit = torch.nonzero(bits, as_tuple=True)
    rows, cols = rows[hit], words[hit] * 32 + bit
    terms = x[rows].double() * r_padded[:, cols].T.double()
    far = terms.sum(1).abs() > eps * terms.abs().sum(1)
    return len(rows), int(far.sum())


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


def route_terms(qbuckets: torch.Tensor, tables: Sequence[TableTerms],
                tidx: Optional[torch.Tensor] = None):
    """(Q, V) buckets over the frozen segments' tables, in stack order ->
    (collisions (K, Q) int32, dead (K, Q) int32, registers (K, Q, m)
    uint8), row k for segment k, as the reference's
    ``TableSegment.estimate_terms`` and ``merge_registers`` give them: the
    bucket sizes less the dead counts, summed; the dead counts, summed (0
    without tombstones); the hit buckets' registers, max-merged."""
    lidx = (torch.arange(qbuckets.shape[1], device=qbuckets.device)
            if tidx is None else tidx.to(torch.int64))[None, :]
    b = qbuckets.to(torch.int64)
    coll, dead, regs = [], [], []
    for t in tables:
        counts = t.starts[lidx, b + 1] - t.starts[lidx, b]
        d = (torch.zeros_like(counts) if t.tomb_counts is None
             else t.tomb_counts[lidx, b])
        coll.append(torch.sum(counts - d, dim=-1, dtype=torch.int32))
        dead.append(torch.sum(d, dim=-1, dtype=torch.int32))
        regs.append(torch.amax(t.registers[lidx, b], dim=1))
    return torch.stack(coll), torch.stack(dead), torch.stack(regs)


def route_estimate(qbuckets: torch.Tensor, tables: Sequence[TableTerms],
                   tidx: Optional[torch.Tensor] = None):
    """(Q, V) buckets over the frozen segments' tables, in stack order ->
    (collisions (Q,) int32, cand (Q,) float32).

    Per segment, from ``route_terms``, as the reference's
    ``finalize_route`` composes it: the collisions summed; the HLL
    estimate of the merged registers, less the dead counts and clamped at
    0 where the segment has tombstones; the estimates added in segment
    order from 0.
    """
    from repro_torch.core import hll as hll_lib   # core imports kernels
    coll_k, dead_k, regs_k = route_terms(qbuckets, tables, tidx)
    coll = torch.sum(coll_k, dim=0, dtype=torch.int32)
    cand = torch.zeros(qbuckets.shape[0], dtype=torch.float32,
                       device=qbuckets.device)
    for t, dead, regs in zip(tables, dead_k, regs_k):
        est = hll_lib.estimate_from_registers(regs)
        if t.tomb_counts is not None:
            est = torch.clamp(est - dead.to(torch.float32), min=0.0)
        cand = cand + est
    return coll, cand


def delta_collide(qbuckets: torch.Tensor, rows: torch.Tensor,
                  live: torch.Tensor, tidx: Optional[torch.Tensor] = None,
                  mode: str = "counts"):
    """The delta's collision test over its n held rows: (Q, V) query
    buckets against the rows' (n, L) buckets (column v probes table
    ``tidx[v]``, or v) and their (n,) ``live`` flags -> ``"counts"``:
    (collisions, distinct), each (Q,) int32, the live (row, column)
    equalities and the live rows equal in a column; ``"mask"``: (Q, n)
    bool, live and equal in a column.  The chain of the reference's
    ``streaming/delta.py`` (a (Q, n, V) bool tensor) on the rows given."""
    rb = rows if tidx is None else rows[:, tidx.to(torch.int64)]
    hit = qbuckets[:, None, :].to(torch.int32) == rb[None, :, :]
    if mode == "mask":
        return torch.any(hit, dim=-1) & live[None, :]
    hit = hit & live[None, :, None]
    return (torch.sum(hit, dim=(1, 2), dtype=torch.int32),
            torch.sum(torch.any(hit, dim=-1), dim=1, dtype=torch.int32))


def scan_epilogue(ids: torch.Tensor, dists: torch.Tensor, mask: torch.Tensor,
                  live: Optional[torch.Tensor], ext: Optional[torch.Tensor]):
    """A segment's linear-scan buffers (Q, n), row n in column n -> what
    it reports: the mask also needs ``live[n]``; ids become ``ext[n]``
    where masked in and ``EXT_SENTINEL`` elsewhere (when ``ext`` is
    given).  The epilogue of both indexes' linear routes, and of K5."""
    n = dists.shape[-1]
    if live is not None:
        mask = mask & live[:n]
    if ext is not None:
        ids = torch.where(mask, ext[:n], torch.full_like(ids, EXT_SENTINEL))
    return ids, dists, mask


def grouped_linear_scan(q: torch.Tensor, parts: Sequence[ScanPart], thresh,
                        metric: str):
    """The linear route over a group of segments: per part
    ``fused_linear_scan`` and ``scan_epilogue``, concatenated along
    columns in order.  Returns (ids, dists, mask), each (Q, sum n)."""
    return concat_columns([scan_epilogue(
        *fused_linear_scan(q, p.x, thresh, metric), p.live, p.ext)
        for p in parts])


def no_columns(q: torch.Tensor):
    """(ids, dists, mask) of a segment holding no rows: (Q, 0) each."""
    return tuple(torch.empty((q.shape[0], 0), dtype=dt, device=q.device)
                 for dt in (torch.int32, torch.float32, torch.bool))


def concat_columns(parts):
    """Concatenate per-segment ``(ids, dists, mask)`` along columns.  A
    part with no columns (an empty delta's) is left out, so a single
    part with columns comes back as it is, not copied."""
    parts = [p for p in parts if p[0].shape[-1]] or parts[:1]
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat([p[i] for p in parts], dim=-1) for i in range(3))
