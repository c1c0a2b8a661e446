"""The Hamming distance matrix kernel (``csrc/fused_scan.cu``).

``hamming`` — the (Q, N) int32 Hamming distance matrix of packed 32-bit
codes, any number of words.  Replaces
``repro.kernels.hamming.hamming_pallas``.  It is the one-segment,
distances-only case of the Hamming linear scan's kernel (K5), so it
lives in that source.  ``ops.hamming_dist`` runs it; its plain version
is ``ref.hamming``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["hamming"]

_P = ctypes.c_void_p
_I = ctypes.c_int


def hamming(qc: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
    """(Q, W) x (N, W) int32 bit views of packed uint32 codes -> (Q, N)
    int32 Hamming distances.  W >= 1."""
    nq, w = qc.shape
    nn = xc.shape[0]
    _build.check(qc, "qc", torch.int32, (nq, w))
    _build.check(xc, "xc", torch.int32, (nn, w))
    if w < 1:
        raise ValueError("hamming needs at least one word per code")
    out = torch.empty((nq, nn), dtype=torch.int32, device=qc.device)
    if nq == 0 or nn == 0:
        return out
    _build.launch("fused_scan", "hamming", [_P, _P, _P, _I, _I, _I, _P],
                  qc.data_ptr(), xc.data_ptr(), out.data_ptr(), nq, nn, w,
                  _build.stream(qc))
    hamming.launches += 1
    return out


hamming.launches = 0
