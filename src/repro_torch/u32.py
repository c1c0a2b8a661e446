"""uint32 arithmetic on int64 tensors.

PyTorch has no uint32 shifts, adds or compares on the CPU, so the port
carries every uint32 value (hashes, packed codes) in an int64 tensor
holding ``[0, 2**32)`` and masks with ``& MASK32`` after each operation
that can leave that range.  Packed codes reach the CUDA kernels as int32
bit views.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor -> int64 holding its uint32 bit pattern."""
    return x.to(torch.int64) & MASK32


def as_i32(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor -> int32 holding its low 32 bits."""
    if x.dtype == torch.int32:
        return x
    v = as_u32(x)
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``(h * c) mod 2**32`` for ``h`` in [0, 2**32): split ``c`` into
    16-bit halves so no int64 product overflows."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32
