"""Public wrappers around the kernels, with dispatch by device.

``impl`` selects what runs, as ``repro.kernels.ops``'s ``impl=`` does:

  * ``None``   — the CUDA kernel for a CUDA tensor, the plain version in
                 ``ref.py`` for a CPU tensor;
  * ``"ref"``  — the plain version on either device (``chip_smoke.py``
                 holds the kernels against it on the card);
  * ``"cuda"`` — the kernel; raises for a CPU tensor.

Nothing falls back: a kernel that fails to build or launch raises.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.kernels import delta_collide as _dc
from repro_torch.kernels import distances as _dist
from repro_torch.kernels import fused_scan as _fs
from repro_torch.kernels import hamming as _ham
from repro_torch.kernels import hll_merge as _hllm
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import simhash as _sim
from repro_torch.kernels.ref import ScanPart, TableTerms
from repro_torch.u32 import as_i32, as_u32

__all__ = ["pairwise_dist", "hamming_dist", "simhash_fingerprint",
           "hll_merge_estimate", "pad_to", "chunked",
           "metric_radius_transform",
           "fused_linear_scan", "fused_lsh_scan", "fused_lsh_scan_unsorted",
           "lsh_group_scan", "grouped_linear_scan", "route_estimate",
           "route_terms", "delta_collide", "ScanPart",
           "TableTerms",
           "resolve_impl"]

IMPLS = ("ref", "cuda")


def resolve_impl(impl: Optional[str], device) -> str:
    """What an ``impl=`` request runs for tensors on ``device``:
    ``"cuda"`` (the kernel) or ``"ref"`` (the plain version)."""
    device = torch.device(device)
    if impl is None:
        return "cuda" if device.type == "cuda" else "ref"
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS} or None, got {impl!r}")
    if impl == "cuda" and device.type != "cuda":
        raise ValueError(f"impl='cuda' needs CUDA tensors, got {device}")
    return impl


def pad_to(x: torch.Tensor, mult: int, axis: int, value=0) -> torch.Tensor:
    """Pad ``axis`` of ``x`` up to a multiple of ``mult`` with ``value``."""
    size = x.shape[axis]
    pad = (-size) % mult
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    fill = torch.full(shape, value, dtype=x.dtype, device=x.device)
    return torch.cat([x, fill], dim=axis)


def chunked(fn, args, pad_values, q_chunk: int = 32):
    """``fn(args)`` -> (ids, dists, mask) over fixed ``q_chunk``-row
    slices of the per-query tensors ``args``.

    A batch of at most ``q_chunk`` rows (or any batch, for ``q_chunk``
    0) is one call on ``args`` as they are.  A longer one is padded up to
    a whole number of slices (each array with its entry in
    ``pad_values``), run slice by slice, and the (Q, ...) results are
    concatenated and sliced back: a 33-query batch runs as two slices.
    On the LSH route only the plain version slices (``lsh_group_scan``):
    K2 verifies a whole group in one launch.  The linear route's K1 / K4
    slice on CUDA too (``grouped_linear_scan``).
    """
    nq = args[0].shape[0]
    if not q_chunk or nq <= q_chunk:
        return fn(args)
    padded = tuple(pad_to(a, q_chunk, 0, value=v)
                   for a, v in zip(args, pad_values))
    outs = [fn(tuple(a[lo:lo + q_chunk] for a in padded))
            for lo in range(0, padded[0].shape[0], q_chunk)]
    return tuple(torch.cat([o[i] for o in outs], dim=0)[:nq]
                 for i in range(3))


def metric_radius_transform(metric: str, r: float) -> float:
    """Map a user radius to the raw-kernel comparison value: the L2 scans
    return *squared* distances, so the threshold is r^2."""
    return r * r if metric == "l2" else r


_PAIRWISE_REF = {"l2": _ref.pairwise_sql2, "l1": _ref.pairwise_l1,
                "cosine": _ref.pairwise_cosine}


def pairwise_dist(q: torch.Tensor, x: torch.Tensor, metric: str,
                  impl: Optional[str] = None) -> torch.Tensor:
    """(Q, d) x (N, d) -> (Q, N) float32 distances for "l2", "l1" or
    "cosine".

    NOTE: metric "l2" returns SQUARED L2 clamped at 0 (compare against
    r^2 via ``metric_radius_transform``).  Inputs of any float type are
    cast to float32.  On CUDA, l2 and cosine run ``pairwise_dot`` (for
    cosine on rows normalised here, per call) and l1 ``pairwise_l1``.
    """
    if metric not in _PAIRWISE_REF:
        raise ValueError(metric)
    if resolve_impl(impl, q.device) == "ref":
        return _PAIRWISE_REF[metric](q, x)
    q = q.to(torch.float32)
    x = x.to(torch.float32)
    if metric == "l1":
        return _dist.pairwise_l1(q.contiguous(), x.contiguous())
    if metric == "cosine":
        return _dist.pairwise_dot(_ref.unit_rows(q).contiguous(),
                                  _ref.unit_rows(x).contiguous(), None, None,
                                  mode="cosine")
    q, x = q.contiguous(), x.contiguous()
    return _dist.pairwise_dot(q, x, torch.sum(q * q, dim=-1),
                              torch.sum(x * x, dim=-1), mode="l2")


def hamming_dist(qc: torch.Tensor, xc: torch.Tensor,
                 impl: Optional[str] = None) -> torch.Tensor:
    """(Q, W) x (N, W) packed uint32 codes (int64 values or int32 bit
    views) -> (Q, N) int32 Hamming distances."""
    if resolve_impl(impl, qc.device) == "ref":
        return _ref.hamming(qc, xc)
    return _ham.hamming(as_i32(qc).contiguous(), as_i32(xc).contiguous())


def pad_projection(r: torch.Tensor, L: int, k: int) -> torch.Tensor:
    """(d, L*k) projection -> (d, L*words*32) zero-padded per table."""
    d = r.shape[0]
    words = (k + 31) // 32
    r = torch.nn.functional.pad(r.reshape(d, L, k), (0, words * 32 - k))
    return r.reshape(d, L * words * 32)


def simhash_fingerprint(x: torch.Tensor, r: torch.Tensor, L: int, k: int,
                        impl: Optional[str] = None) -> torch.Tensor:
    """(N, d) points, (d, L*k) projections -> (N, L, ceil(k/32)) packed
    uint32 words (int64 holding [0, 2**32), as ``SimHash.codes``)."""
    words = (k + 31) // 32
    rp = pad_projection(r, L, k)
    if resolve_impl(impl, x.device) == "ref":
        return _ref.simhash_fingerprint(x, rp, L, words)
    return as_u32(_sim.simhash(x.to(torch.float32).contiguous(),
                               rp.to(torch.float32).contiguous(), L, k))


def fused_linear_scan(q: torch.Tensor, x: torch.Tensor, r, metric: str,
                      impl: Optional[str] = None,
                      x_unit: Optional[torch.Tensor] = None):
    """Fused linear-route scan: distance + threshold + report mask +
    candidate ids in one kernel pass over (Q, N).

    q: (Q, d) queries ((Q, W) packed codes for hamming); x: (N, d)
    corpus ((N, W) for hamming); r: report radius.  Returns (ids (Q, N)
    i32, dists (Q, N) f32, mask (Q, N) bool).  On CUDA, l2 and cosine
    run ``linear_scan_dot``, l1 ``linear_scan_l1`` and hamming
    ``linear_scan_hamming``.  ``x_unit``: for cosine, x's rows already
    scaled to unit length (contiguous float32), which the kernel route
    reads instead of normalising x on every call; the plain version
    ignores it.
    """
    impl = resolve_impl(impl, q.device)
    thresh = metric_radius_transform(metric, r)
    if impl == "ref":
        return _ref.fused_linear_scan(q, x, thresh, metric)
    if metric == "hamming":
        dists, mask, ids = _fs.linear_scan_hamming(
            thresh, as_i32(q).contiguous(), [ScanPart(as_i32(x).contiguous())])
        return ids, dists, mask
    if metric == "l1":
        dists, mask, ids = _fs.linear_scan_l1(
            thresh, q.to(torch.float32).contiguous(),
            x.to(torch.float32).contiguous())
        return ids, dists, mask
    if metric not in _fs.LINEAR_MODES:
        raise ValueError(metric)
    q = q.to(torch.float32)
    x = x.to(torch.float32)
    if metric == "cosine":        # normalised rows; the norms go unread
        if x_unit is None:
            x_unit = _ref.unit_rows(x)
        q, x = _ref.unit_rows(q).contiguous(), x_unit.contiguous()
        qn, xn = q.new_empty(q.shape[0]), x.new_empty(x.shape[0])
    else:
        q, x = q.contiguous(), x.contiguous()
        qn, xn = torch.sum(q * q, dim=-1), torch.sum(x * x, dim=-1)
    dists, mask, ids = _fs.linear_scan_dot(thresh, q, x, qn, xn, mode=metric)
    return ids, dists, mask


def fused_lsh_scan_unsorted(x: torch.Tensor, cands: torch.Tensor,
                            q: torch.Tensor, r, metric: str,
                            impl: Optional[str] = None,
                            x_unit: Optional[torch.Tensor] = None):
    """Fused LSH-route candidate verification from the gather's unsorted
    candidates: sort + run dedup + row gather + rowwise distance +
    threshold.

    x: (n, d) corpus (packed 32-bit codes for hamming); cands: (Q, C)
    candidate ids in any order, each in [0, n] (sentinel = n); q: (Q, d).
    Returns (ids (Q, C) i32 sorted, dists (Q, C) f32, mask (Q, C) bool)
    with duplicates, sentinels and out-of-radius rows masked.  On CUDA
    one kernel (``fused_scan.lsh_scan``); the plain version sorts with
    ``torch.sort`` and runs ``ref.fused_lsh_scan``.  ``x_unit``: for
    cosine, x's rows already scaled to unit length (contiguous float32),
    which the kernel gathers instead of x, computing 1 - x.q against the
    query row it scales itself (made here when None); the plain version
    ignores it.
    """
    impl = resolve_impl(impl, x.device)
    thresh = metric_radius_transform(metric, r)
    if impl == "ref":
        ids = torch.sort(cands, dim=-1).values
        return _ref.fused_lsh_scan(x, ids, _run_prev(ids), q, thresh, metric)
    if metric == "hamming":
        x, q = as_i32(x), as_i32(q)
    elif metric == "cosine":
        if x_unit is None:
            x_unit = _ref.unit_rows(x.to(torch.float32))
        x, q, metric = x_unit, q.to(torch.float32), "cosine_unit"
    else:
        x, q = x.to(torch.float32), q.to(torch.float32)
    return _fs.lsh_scan(thresh, x.contiguous(), q.contiguous(),
                        cands.to(torch.int32).contiguous(), metric=metric)


def lsh_group_scan(x: torch.Tensor, cands: torch.Tensor, q: torch.Tensor,
                   r, metric: str, impl: Optional[str] = None,
                   x_unit: Optional[torch.Tensor] = None, q_chunk: int = 32):
    """The LSH route's verification of one routed group on one segment:
    what ``fused_lsh_scan_unsorted`` reports for the (Q, C) unsorted
    candidates ``cands`` of the queries ``q``.  What runs:

      * CUDA — K2 over all Q queries in one launch
        (``fused_scan.lsh_scan``; past 65,535 queries one a slice of that
        many), writing its outputs in place;
      * CPU, or ``impl="ref"`` — the plain version once a ``q_chunk``
        slice (``chunked``; a partial slice padded with sentinel
        candidates): its gather holds (slice, C, d) floats.
    """
    if resolve_impl(impl, x.device) == "cuda":
        return fused_lsh_scan_unsorted(x, cands, q, r, metric, impl=impl,
                                       x_unit=x_unit)
    return chunked(lambda a: fused_lsh_scan_unsorted(
        x, a[0], a[1], r, metric, impl=impl, x_unit=x_unit),
        (cands, q), (x.shape[0], 0), q_chunk)


def _run_prev(ids: torch.Tensor) -> torch.Tensor:
    """``ids`` shifted right one slot, -1 first: ``ids != prev`` marks
    the runs' first slots (the plain version's dedup)."""
    return torch.cat([torch.full(ids.shape[:-1] + (1,), -1, dtype=ids.dtype,
                                 device=ids.device), ids[..., :-1]], dim=-1)


def fused_lsh_scan(x: torch.Tensor, ids_sorted: torch.Tensor,
                   q: torch.Tensor, r, metric: str,
                   impl: Optional[str] = None):
    """Fused LSH-route candidate verification of *sorted* candidates:
    run dedup + row gather + rowwise distance + threshold, as
    ``repro.kernels.ops.fused_lsh_scan``.

    x: (n, d) corpus (packed 32-bit codes for hamming); ids_sorted:
    (Q, C) sorted candidate ids with sentinel = n; q: (Q, d).  Returns
    (ids (Q, C) i32, dists (Q, C) f32, mask (Q, C) bool) with duplicates,
    sentinels and out-of-radius rows masked.  On CUDA it runs the kernel
    of ``fused_lsh_scan_unsorted``: sorting sorted ids changes nothing.
    """
    if resolve_impl(impl, x.device) == "ref":
        thresh = metric_radius_transform(metric, r)
        return _ref.fused_lsh_scan(x, ids_sorted, _run_prev(ids_sorted), q,
                                   thresh, metric)
    return fused_lsh_scan_unsorted(x, ids_sorted, q, r, metric, impl=impl)


def hll_merge_estimate(regs: torch.Tensor,
                       impl: Optional[str] = None) -> torch.Tensor:
    """(Q, L, m) uint8 registers -> (Q,) float32 candSize estimates."""
    if resolve_impl(impl, regs.device) == "ref":
        return _ref.hll_merge_estimate(regs)
    return _hllm.hll_merge_estimate(regs)


def grouped_linear_scan(q: torch.Tensor, parts: Sequence[ScanPart], r,
                        metric: str, impl: Optional[str] = None):
    """The linear route of one routed group over every segment of an
    index: (ids, dists, mask), each (Q, sum n), part s in its own
    columns, in order.

    ``parts``: ``ScanPart``s (x, live, ext, x_unit).  Each part reports
    what ``fused_linear_scan`` reports over its rows, with ``live[n]`` in
    the mask and, where it has ``ext``, ``ext[n]`` as the id where masked
    in and ``ref.EXT_SENTINEL`` elsewhere.  What runs:

      * CUDA, hamming — one kernel launch over all the parts and queries
        (``fused_scan.linear_scan_hamming``);
      * CUDA, l2 / cosine / l1 — on each part that holds rows, K1 or K4
        (``fused_linear_scan``, reading the part's ``x_unit`` for cosine)
        once a slice of 32 queries (``chunked``), then ``ref.scan_epilogue``;
        a part of no rows launches nothing and adds no column;
      * CPU, or ``impl="ref"`` — the plain version,
        ``ref.grouped_linear_scan``, any metric.
    """
    impl = resolve_impl(impl, q.device)
    thresh = metric_radius_transform(metric, r)
    if impl == "ref":
        return _ref.grouped_linear_scan(q, parts, thresh, metric)
    if metric == "hamming":
        dists, mask, ids = _fs.linear_scan_hamming(
            thresh, as_i32(q).contiguous(),
            [p._replace(x=as_i32(p.x).contiguous()) for p in parts])
        return ids, dists, mask

    def scan(p):
        return _ref.scan_epilogue(*chunked(
            lambda a: fused_linear_scan(a[0], p.x, r, metric, impl=impl,
                                        x_unit=p.x_unit), (q,), (0,)),
            p.live, p.ext)
    return _ref.concat_columns([scan(p) for p in parts if p.x.shape[0]]
                               or [_ref.no_columns(q)])


def route_estimate(qbuckets: torch.Tensor, tables: Sequence[TableTerms],
                   tidx: Optional[torch.Tensor] = None,
                   impl: Optional[str] = None):
    """Algorithm 2 lines 1-2 over the frozen segments of an index:
    (Q, V) query buckets and each segment's ``TableTerms`` (starts,
    registers, tomb_counts or None), in stack order -> (collisions (Q,)
    int32, cand (Q,) float32): the tombstone-corrected bucket sizes and
    the sum, from 0 in segment order, of each segment's HLL estimate less
    its dead collisions (clamped at 0).  ``tidx``: (V,) column -> table
    map under multi-probe.  On CUDA one kernel launch
    (``hll_merge.route_estimate``)."""
    if resolve_impl(impl, qbuckets.device) == "ref":
        return _ref.route_estimate(qbuckets, tables, tidx)
    return _hllm.route_estimate(
        qbuckets.to(torch.int32).contiguous(), tables,
        None if tidx is None else tidx.to(torch.int32).contiguous())


def route_terms(qbuckets: torch.Tensor, tables: Sequence[TableTerms],
                tidx: Optional[torch.Tensor] = None,
                impl: Optional[str] = None):
    """Each frozen segment's routing terms, before the estimate: (Q, V)
    query buckets and the segments' ``TableTerms`` -> (collisions (K, Q)
    int32, dead (K, Q) int32, registers (K, Q, m) uint8), row k for
    segment k (its live collisions, its dead collisions, the max-merge of
    its hit buckets' registers).  What a row-sharded index sums and
    max-merges across its shards, level by level, before it estimates.
    On CUDA one launch of K3's kernel in its terms mode
    (``hll_merge.route_terms``)."""
    if resolve_impl(impl, qbuckets.device) == "ref":
        return _ref.route_terms(qbuckets, tables, tidx)
    return _hllm.route_terms(
        qbuckets.to(torch.int32).contiguous(), tables,
        None if tidx is None else tidx.to(torch.int32).contiguous())


def delta_collide(qbuckets: torch.Tensor, rows: torch.Tensor,
                  live: torch.Tensor, tidx: Optional[torch.Tensor] = None,
                  mode: str = "counts", impl: Optional[str] = None):
    """The streaming delta's collision test over the n rows it holds:
    (Q, V) query buckets, the rows' (n, L) bucket ids and (n,) live flags,
    ``tidx`` the (V,) column -> table map under multi-probe.  ``"counts"``
    -> (collisions, distinct), each (Q,) int32 and exact; ``"mask"`` ->
    (Q, n) bool, the live rows equal to the query in a probed column.  On
    CUDA one launch (``delta_collide.delta_collide``), none for n = 0;
    the plain version is ``ref.delta_collide``."""
    if resolve_impl(impl, qbuckets.device) == "ref":
        return _ref.delta_collide(qbuckets, rows, live, tidx, mode)
    return _dc.delta_collide(
        qbuckets.to(torch.int32).contiguous(), rows, live,
        None if tidx is None else tidx.to(torch.int32).contiguous(), mode)
