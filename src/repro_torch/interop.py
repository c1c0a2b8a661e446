"""Carry the reference's random draws and tables into the port.

Takes numpy arrays only, so a test can hand the port the exact family
parameters (and even the exact CSR tables) of a ``repro`` index without
relying on two random number generators agreeing.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.lsh.tables import LSHTables

__all__ = ["params_from_numpy", "tables_from_numpy"]


def _tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.array(a)                  # a writable copy (JAX arrays are not)
    if a.dtype == np.uint32:         # torch's CPU ops want a signed view
        a = a.astype(np.int64)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


_PARAM_DTYPES = {"R": torch.float32, "a": torch.float32, "b": torch.float32,
                 "pos": torch.int32}


def params_from_numpy(params: Dict[str, np.ndarray],
                      device) -> Dict[str, torch.Tensor]:
    """Family params (``R`` for SimHash, ``a``/``b`` for the p-stable
    families, ``pos`` for BitSampling) as tensors on ``device``."""
    unknown = set(params) - set(_PARAM_DTYPES)
    if unknown:
        raise KeyError(f"unknown family params {sorted(unknown)}")
    return {k: _tensor(v, _PARAM_DTYPES[k], device)
            for k, v in params.items()}


def tables_from_numpy(perm, starts, registers, device) -> LSHTables:
    """Built CSR tables and HLL registers as an ``LSHTables`` on
    ``device``: perm (L, n) and starts (L, B + 1) int32, registers
    (L, B, m) uint8."""
    return LSHTables(_tensor(perm, torch.int32, device),
                     _tensor(starts, torch.int32, device),
                     _tensor(registers, torch.uint8, device))
