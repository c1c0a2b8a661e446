"""The fused query-route scan kernels (``csrc/fused_scan.cu``).

  * ``linear_scan_dot`` — the linear route for l2 and cosine: distance,
    threshold, report mask and ids in one pass over (Q, N).  Replaces
    ``repro.kernels.fused_scan.linear_scan_dot_pallas``.
  * ``linear_scan_l1`` — the same pass for L1 (sum of |q - x|, on the
    CUDA cores).  Replaces ``linear_scan_l1_pallas``.
  * ``linear_scan_hamming`` — the same pass over packed 32-bit codes
    (XOR + popcount).  Replaces ``linear_scan_hamming_pallas``.
  * ``lsh_scan`` — the LSH route's verification: sorted-run dedup, row
    gather, rowwise l2/l1/cosine/Hamming distance and threshold over the
    (Q, C) candidates.  Replaces ``lsh_scan_pallas``.  The corpus is
    gathered from device memory, never staged whole on chip.

Their plain versions are ``ref.fused_linear_scan`` and
``ref.fused_lsh_scan``; ``ops`` chooses between them by device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import fused_linear_scan as fused_linear_scan_ref
from repro_torch.kernels.ref import fused_lsh_scan as fused_lsh_scan_ref

__all__ = ["linear_scan_dot", "linear_scan_l1", "linear_scan_hamming",
           "lsh_scan", "fused_linear_scan_ref", "fused_lsh_scan_ref",
           "LSH_METRICS"]

LINEAR_MODES = {"l2": 0, "cosine": 1}
LSH_METRICS = {"l2": 0, "l1": 1, "cosine": 2, "hamming": 3}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def linear_scan_dot(thresh: float, q: torch.Tensor, x: torch.Tensor,
                    qn: torch.Tensor, xn: torch.Tensor, *, mode: str):
    """(Q, d) x (N, d) float32 -> (dists f32, mask bool, ids i32), (Q, N).

    ``mode`` "l2": distance ||q||^2 + ||x||^2 - 2 q.x clamped at 0, with
    ``qn``/``xn`` the squared norms; "cosine": 1 - q.x on rows the caller
    normalised (``qn``/``xn`` unread).  ``thresh`` is r^2 for l2.
    """
    nq, d = q.shape
    nn = x.shape[0]
    _build.check(q, "q", torch.float32, (nq, d))
    _build.check(x, "x", torch.float32, (nn, d))
    _build.check(qn, "qn", torch.float32, (nq,))
    _build.check(xn, "xn", torch.float32, (nn,))
    dist, mask, ids = _linear_outputs(nq, nn, q.device)
    if nq == 0 or nn == 0:
        return dist, mask, ids
    _build.launch("fused_scan", "linear_scan_dot",
                  [_P, _P, _P, _P, _F, _I, _P, _P, _P, _I, _I, _I, _P],
                  q.data_ptr(), x.data_ptr(), qn.data_ptr(), xn.data_ptr(),
                  float(thresh), LINEAR_MODES[mode], dist.data_ptr(),
                  mask.data_ptr(), ids.data_ptr(), nq, nn, d,
                  _build.stream(q))
    linear_scan_dot.launches += 1
    return dist, mask, ids


def _linear_outputs(nq: int, nn: int, dev):
    return (torch.empty((nq, nn), dtype=torch.float32, device=dev),
            torch.empty((nq, nn), dtype=torch.bool, device=dev),
            torch.empty((nq, nn), dtype=torch.int32, device=dev))


def linear_scan_l1(thresh: float, q: torch.Tensor, x: torch.Tensor):
    """(Q, d) x (N, d) float32 -> (dists f32, mask bool, ids i32), (Q, N):
    sum |q - x|, the mask ``dist <= thresh``."""
    nq, d = q.shape
    nn = x.shape[0]
    _build.check(q, "q", torch.float32, (nq, d))
    _build.check(x, "x", torch.float32, (nn, d))
    dist, mask, ids = _linear_outputs(nq, nn, q.device)
    if nq == 0 or nn == 0:
        return dist, mask, ids
    _build.launch("fused_scan", "linear_scan_l1",
                  [_P, _P, _F, _P, _P, _P, _I, _I, _I, _P],
                  q.data_ptr(), x.data_ptr(), float(thresh), dist.data_ptr(),
                  mask.data_ptr(), ids.data_ptr(), nq, nn, d,
                  _build.stream(q))
    linear_scan_l1.launches += 1
    return dist, mask, ids


def linear_scan_hamming(thresh: float, q: torch.Tensor, x: torch.Tensor):
    """(Q, W) x (N, W) int32 bit views of packed uint32 codes -> (dists
    f32, mask bool, ids i32), (Q, N): the Hamming distance (exact in
    float32), the mask ``float(dist) <= thresh``.  W >= 1."""
    nq, w = q.shape
    nn = x.shape[0]
    _build.check(q, "q", torch.int32, (nq, w))
    _build.check(x, "x", torch.int32, (nn, w))
    if w < 1:
        raise ValueError("linear_scan_hamming needs at least one word per code")
    dist, mask, ids = _linear_outputs(nq, nn, q.device)
    if nq == 0 or nn == 0:
        return dist, mask, ids
    _build.launch("fused_scan", "linear_scan_hamming",
                  [_P, _P, _F, _P, _P, _P, _I, _I, _I, _P],
                  q.data_ptr(), x.data_ptr(), float(thresh), dist.data_ptr(),
                  mask.data_ptr(), ids.data_ptr(), nq, nn, w,
                  _build.stream(q))
    linear_scan_hamming.launches += 1
    return dist, mask, ids


def lsh_scan(thresh: float, x: torch.Tensor, q: torch.Tensor,
             ids: torch.Tensor, prev: torch.Tensor, *, metric: str):
    """Verify sorted (Q, C) int32 candidates -> (dists f32, mask bool).

    x: (n, d) corpus and q: (Q, d) queries, float32 — or int32 bit views
    of packed uint32 codes for "hamming"; ``prev`` is ``ids`` shifted
    right one slot (-1 first); sentinel = n.  Distances of masked-out
    duplicate and sentinel slots are +inf and not part of the contract.
    """
    nq, c = ids.shape
    n, d = x.shape
    dtype = torch.int32 if metric == "hamming" else torch.float32
    _build.check(x, "x", dtype, (n, d))
    _build.check(q, "q", dtype, (nq, d))
    _build.check(ids, "ids", torch.int32, (nq, c))
    _build.check(prev, "prev", torch.int32, (nq, c))
    dev = x.device
    dist = torch.empty((nq, c), dtype=torch.float32, device=dev)
    mask = torch.empty((nq, c), dtype=torch.bool, device=dev)
    if nq == 0 or c == 0:
        return dist, mask
    _build.launch("fused_scan", "lsh_scan",
                  [_I, _P, _P, _P, _P, _F, _P, _P, _I, _I, _I, _I, _P],
                  LSH_METRICS[metric], x.data_ptr(), q.data_ptr(),
                  ids.data_ptr(), prev.data_ptr(), float(thresh),
                  dist.data_ptr(), mask.data_ptr(), nq, c, n, d,
                  _build.stream(x))
    lsh_scan.launches += 1
    return dist, mask


linear_scan_dot.launches = 0
linear_scan_l1.launches = 0
linear_scan_hamming.launches = 0
lsh_scan.launches = 0
