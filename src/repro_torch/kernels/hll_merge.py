"""The route-estimate kernel (``csrc/hll_merge.cu``), the step the paper
adds on the query path (Algorithm 2, lines 1-2).

  * ``route_estimate`` — per query, over every frozen segment of an index
    in one launch: the exact bucket collisions (tombstone-corrected) and
    the sum of the segments' HLL candSize estimates, each the max-merge of
    the hit buckets' registers and the estimator with its small/large-range
    corrections, less the segment's dead collisions.  Its plain version is
    ``ref.route_estimate``.
  * ``route_terms`` — the same kernel in its terms mode: per segment, the
    exact live collisions, the dead collisions and the (Q, m) max-merged
    registers, stopped before the estimate, which a row-sharded index
    takes only after it has summed and max-merged them across its shards.
    Its plain version is ``ref.route_terms``.
  * ``hll_merge_estimate`` — the same kernel on (Q, L, m) registers
    gathered by the caller (``ops.hll_merge_estimate``): one segment,
    bucket = query, no collisions.  Its plain version is
    ``ref.hll_merge_estimate``.

Replaces ``repro.kernels.hll_merge.hll_merge_estimate_pallas``, with the
per-segment gathers and sums around it in ``repro.core.engine``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.hll import _alpha
from repro_torch.kernels import _build
from repro_torch.kernels.ref import TableTerms
from repro_torch.kernels.ref import hll_merge_estimate as hll_merge_estimate_ref
from repro_torch.kernels.ref import route_estimate as route_estimate_ref
from repro_torch.kernels.ref import route_terms as route_terms_ref

__all__ = ["route_estimate", "route_terms", "hll_merge_estimate",
           "route_estimate_ref", "route_terms_ref", "hll_merge_estimate_ref",
           "ROUTE_MAX_SEGMENTS"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64

ROUTE_MAX_SEGMENTS = 64   # kRouteMaxSegs: segments a launch


class _RouteSeg(ctypes.Structure):
    _fields_ = [("starts", _P), ("regs", _P), ("tomb", _P), ("tstride", _I64),
                ("bstride", _I64), ("B", _I)]


class _RouteArgs(ctypes.Structure):
    _fields_ = [("qb", _P), ("tidx", _P), ("coll", _P), ("cand", _P),
                ("dead", _P), ("regs", _P), ("Q", _I), ("V", _I), ("m", _I), ("nseg", _I),
                ("coef", ctypes.c_float), ("accumulate", _I),
                ("seg", _RouteSeg * ROUTE_MAX_SEGMENTS)]


def _coef(m: int) -> float:
    return float(np.float32(_alpha(m) * m * m))


def _check_m(m: int) -> None:
    if m & (m - 1) or not 0 < m <= 1024:
        raise ValueError(f"m must be a power of two <= 1024, got {m}")


def _checked_tables(qbuckets, tables, tidx):
    """Check the inputs of ``route_estimate`` / ``route_terms``; returns
    (Q, V, m)."""
    nq, v = qbuckets.shape
    _build.check(qbuckets, "qbuckets", torch.int32, (nq, v))
    if not tables:
        raise ValueError("route_estimate needs at least one segment")
    L, _, m = tables[0].registers.shape
    _check_m(m)
    if tidx is not None:
        _build.check(tidx, "tidx", torch.int32, (v,))
    elif v != L:
        raise ValueError(f"qbuckets has {v} columns for {L} tables and no tidx")
    for t in tables:
        b = t.registers.shape[1]
        _build.check(t.registers, "registers", torch.uint8, (L, b, m))
        _build.check(t.starts, "starts", torch.int32, (L, b + 1))
        if t.tomb_counts is not None:
            _build.check(t.tomb_counts, "tomb_counts", torch.int32, (L, b))
    _build.check_layout("hll_merge", "route_estimate_args_bytes", _RouteArgs)
    return nq, v, m


def _launches(entry, qbuckets, tables, tidx, nq, v, m, out):
    """Launch ``entry`` over ``tables``, ``ROUTE_MAX_SEGMENTS`` a launch;
    ``out(lo)`` gives the (coll, cand, dead, regs) pointers and the
    accumulate flag of the launch that starts at segment ``lo``.
    Returns the number of launches."""
    n = 0
    for lo in range(0, len(tables), ROUTE_MAX_SEGMENTS):
        group = tables[lo:lo + ROUTE_MAX_SEGMENTS]
        coll, cand, dead, regs, accumulate = out(lo)
        a = _RouteArgs(qb=qbuckets.data_ptr(),
                       tidx=None if tidx is None else tidx.data_ptr(),
                       coll=coll, cand=cand, dead=dead, regs=regs, Q=nq,
                       V=v, m=m, nseg=len(group), coef=_coef(m),
                       accumulate=accumulate)
        for i, t in enumerate(group):
            b = t.registers.shape[1]
            a.seg[i] = _RouteSeg(
                t.starts.data_ptr(), t.registers.data_ptr(),
                None if t.tomb_counts is None else t.tomb_counts.data_ptr(),
                b * m, m, b)
        _build.launch("hll_merge", entry, [_P, _P], ctypes.addressof(a),
                      _build.stream(qbuckets))
        n += 1
    return n


def route_estimate(qbuckets: torch.Tensor, tables: Sequence[TableTerms],
                   tidx: Optional[torch.Tensor] = None):
    """(Q, V) int32 CUDA buckets and the frozen segments' tables, in stack
    order -> (collisions (Q,) int32, cand (Q,) float32) summed over them.

    ``tables``: ``ref.TableTerms`` (starts (L, B + 1) int32, registers
    (L, B, m) uint8, tomb_counts (L, B) int32 or None), every one with the
    same L and m.  ``tidx``: (V,) int32 column -> table map, or None when
    column j is table j (V = L).  One launch for up to
    ``ROUTE_MAX_SEGMENTS`` segments; a longer stack takes more, each
    continuing the sums of the last.
    """
    nq, v, m = _checked_tables(qbuckets, tables, tidx)
    dev = qbuckets.device
    coll = torch.empty(nq, dtype=torch.int32, device=dev)
    cand = torch.empty(nq, dtype=torch.float32, device=dev)
    if nq == 0:
        return coll, cand
    route_estimate.launches += _launches(
        "route_estimate", qbuckets, tables, tidx, nq, v, m,
        lambda lo: (coll.data_ptr(), cand.data_ptr(), None, None,
                    int(lo > 0)))
    return coll, cand


def route_terms(qbuckets: torch.Tensor, tables: Sequence[TableTerms],
                tidx: Optional[torch.Tensor] = None):
    """The terms mode of ``route_estimate``'s kernel: the same inputs ->
    (collisions (K, Q) int32, dead (K, Q) int32, registers (K, Q, m)
    uint8), row k for segment k: its tombstone-corrected collisions, its
    dead collisions (0 without tombstones) and the max-merge of its hit
    buckets' registers.  One launch for up to ``ROUTE_MAX_SEGMENTS``
    segments."""
    nq, v, m = _checked_tables(qbuckets, tables, tidx)
    dev, k = qbuckets.device, len(tables)
    coll = torch.empty((k, nq), dtype=torch.int32, device=dev)
    dead = torch.empty((k, nq), dtype=torch.int32, device=dev)
    regs = torch.empty((k, nq, m), dtype=torch.uint8, device=dev)
    if nq == 0:
        return coll, dead, regs
    route_terms.launches += _launches(
        "route_terms", qbuckets, tables, tidx, nq, v, m,
        lambda lo: (coll[lo].data_ptr(), None, dead[lo].data_ptr(),
                    regs[lo].data_ptr(), 0))
    return coll, dead, regs


def hll_merge_estimate(regs: torch.Tensor) -> torch.Tensor:
    """(Q, L, m) uint8 CUDA registers -> (Q,) float32 candSize estimates."""
    if not regs.is_cuda:
        raise ValueError("hll_merge_estimate launches on CUDA tensors only")
    if regs.dtype != torch.uint8 or regs.ndim != 3:
        raise ValueError(f"want (Q, L, m) uint8, got {tuple(regs.shape)} "
                         f"{regs.dtype}")
    q, L, m = regs.shape
    _check_m(m)
    regs = regs.contiguous()
    out = torch.empty(q, dtype=torch.float32, device=regs.device)
    if q == 0:
        return out
    _build.launch("hll_merge", "hll_merge_estimate",
                  [_P, _P, _I, _I, _I, ctypes.c_float, _P],
                  regs.data_ptr(), out.data_ptr(), q, L, m, _coef(m),
                  _build.stream(regs))
    hll_merge_estimate.launches += 1
    return out


route_estimate.launches = 0
route_terms.launches = 0
hll_merge_estimate.launches = 0
