"""The distance-matrix kernels (``csrc/fused_scan.cu``).

  * ``pairwise_dot`` — the (Q, N) squared-L2 or cosine distance matrix.
    Replaces ``repro.kernels.distances.pairwise_dot_pallas``.
  * ``pairwise_l1`` — the (Q, N) L1 distance matrix.  Replaces
    ``pairwise_l1_pallas``.

Each is a linear scan's kernel with a distances-only epilogue, so they
live in the same source (the Hamming matrix, ``kernels/hamming.py``,
too).  ``cost_model.calibrate`` times them through
``ops.pairwise_dist``.  Their plain versions are ``ref.pairwise_sql2``,
``ref.pairwise_cosine`` and ``ref.pairwise_l1``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_scan import LINEAR_MODES

__all__ = ["pairwise_dot", "pairwise_l1"]

_P = ctypes.c_void_p
_I = ctypes.c_int


def pairwise_dot(q: torch.Tensor, x: torch.Tensor,
                 qn: Optional[torch.Tensor], xn: Optional[torch.Tensor], *,
                 mode: str) -> torch.Tensor:
    """(Q, d) x (N, d) float32 -> (Q, N) float32 distances.

    ``mode`` "l2": ||q||^2 + ||x||^2 - 2 q.x clamped at 0, with ``qn`` /
    ``xn`` the squared norms; "cosine": 1 - q.x on rows the caller
    normalised (``qn`` / ``xn`` unread, may be None).
    """
    if mode not in LINEAR_MODES:
        raise ValueError(f"mode must be one of {sorted(LINEAR_MODES)}, "
                         f"got {mode!r}")
    nq, d = q.shape
    nn = x.shape[0]
    _build.check(q, "q", torch.float32, (nq, d))
    _build.check(x, "x", torch.float32, (nn, d))
    if mode == "l2":
        _build.check(qn, "qn", torch.float32, (nq,))
        _build.check(xn, "xn", torch.float32, (nn,))
    out = torch.empty((nq, nn), dtype=torch.float32, device=q.device)
    if nq == 0 or nn == 0:
        return out
    _build.launch("fused_scan", "pairwise_dot",
                  [_P, _P, _P, _P, _I, _P, _I, _I, _I, _P],
                  q.data_ptr(), x.data_ptr(),
                  None if mode == "cosine" else qn.data_ptr(),
                  None if mode == "cosine" else xn.data_ptr(),
                  LINEAR_MODES[mode], out.data_ptr(), nq, nn, d,
                  _build.stream(q))
    pairwise_dot.launches += 1
    return out


def pairwise_l1(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(Q, d) x (N, d) float32 -> (Q, N) float32 sums of |q - x|."""
    nq, d = q.shape
    nn = x.shape[0]
    _build.check(q, "q", torch.float32, (nq, d))
    _build.check(x, "x", torch.float32, (nn, d))
    out = torch.empty((nq, nn), dtype=torch.float32, device=q.device)
    if nq == 0 or nn == 0:
        return out
    _build.launch("fused_scan", "pairwise_l1", [_P, _P, _P, _I, _I, _I, _P],
                  q.data_ptr(), x.data_ptr(), out.data_ptr(), nq, nn, d,
                  _build.stream(q))
    pairwise_l1.launches += 1
    return out


pairwise_dot.launches = 0
pairwise_l1.launches = 0
