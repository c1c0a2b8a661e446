"""The HLL merge + estimate kernel (``csrc/hll_merge.cu``), the step the
paper adds on the query path (Algorithm 2, line 2).

Per query: max-merge the (L, m) gathered registers, then the HLL
estimator with small/large-range corrections.  Replaces
``repro.kernels.hll_merge.hll_merge_estimate_pallas``; its plain version
is ``ref.hll_merge_estimate``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.hll import _alpha
from repro_torch.kernels import _build
from repro_torch.kernels.ref import hll_merge_estimate as hll_merge_estimate_ref

__all__ = ["hll_merge_estimate", "hll_merge_estimate_ref"]


def hll_merge_estimate(regs: torch.Tensor) -> torch.Tensor:
    """(Q, L, m) uint8 CUDA registers -> (Q,) float32 candSize estimates."""
    if not regs.is_cuda:
        raise ValueError("hll_merge_estimate launches on CUDA tensors only")
    if regs.dtype != torch.uint8 or regs.ndim != 3:
        raise ValueError(f"want (Q, L, m) uint8, got {tuple(regs.shape)} "
                         f"{regs.dtype}")
    q, L, m = regs.shape
    if m & (m - 1) or not 0 < m <= 1024:
        raise ValueError(f"m must be a power of two <= 1024, got {m}")
    regs = regs.contiguous()
    out = torch.empty(q, dtype=torch.float32, device=regs.device)
    if q == 0:
        return out
    coef = float(np.float32(_alpha(m) * m * m))
    _build.launch("hll_merge", "hll_merge_estimate",
                  [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_void_p],
                  regs.data_ptr(), out.data_ptr(), q, L, m, coef,
                  _build.stream(regs))
    hll_merge_estimate.launches += 1
    return out


hll_merge_estimate.launches = 0
