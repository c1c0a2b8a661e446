"""HyperLogLog sketches in PyTorch (Flajolet et al., AofA'07).

The paper attaches one HLL to every LSH bucket so that the union
cardinality of the L buckets colliding with a query (= ``candSize`` in
Eq. (1)) can be estimated in O(m*L) time, independent of bucket sizes.

Per-bucket HLLs are a dense ``(num_buckets, m)`` register array built
in one ``scatter_reduce`` pass.  Register updates are keyed on the
*global* point id, so the same point produces the same ``(register,
rank)`` pair in every table; merging registers with ``max`` computes
the exact HLL of the distinct union.

Hashes are uint32 values carried in int64 tensors (``repro_torch.u32``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.u32 import MASK32, as_u32, mul32

__all__ = [
    "hash32",
    "clz32",
    "point_register_rank",
    "build_bucket_hlls",
    "merge_registers",
    "estimate_cardinality",
    "estimate_from_registers",
    "relative_error",
]

# Murmur3-style 32-bit finalizer constants.
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9


def hash32(x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Murmur3 fmix32 of ``x`` (any integer dtype) -> int64 in [0, 2**32).

    Used both for HLL register/rank derivation and for bucket-id mixing
    in the LSH tables.
    """
    h = (as_u32(x) + ((int(seed) * _GOLDEN) & MASK32)) & MASK32
    h = h ^ (h >> 16)
    h = mul32(h, _C1)
    h = h ^ (h >> 13)
    h = mul32(h, _C2)
    h = h ^ (h >> 16)
    return h


def clz32(x: torch.Tensor) -> torch.Tensor:
    """Branchless count-leading-zeros of uint32 values (32 for x == 0),
    as int32."""
    x = as_u32(x)
    n = torch.zeros_like(x, dtype=torch.int32)
    for shift, mask in ((16, 0x0000FFFF), (8, 0x00FFFFFF), (4, 0x0FFFFFFF),
                        (2, 0x3FFFFFFF), (1, 0x7FFFFFFF)):
        small = x <= mask
        n = torch.where(small, n + shift, n)
        x = torch.where(small, (x << shift) & MASK32, x)
    return torch.where(x == 0, torch.full_like(n, 32), n)


def point_register_rank(ids: torch.Tensor, m: int, seed: int = 0):
    """Derive the HLL ``(register, rank)`` update pair for point ids.

    The top ``p = log2(m)`` bits of the 32-bit hash select the register;
    the rank is the number of leading zeros of the remaining ``32 - p``
    bits plus one (capped there by an implicit sentinel bit).
    """
    p = int(m).bit_length() - 1
    if (1 << p) != m:
        raise ValueError(f"m must be a power of two, got {m}")
    h = hash32(ids, seed)
    reg = (h >> (32 - p)).to(torch.int32)
    rest = ((h << p) & MASK32) | (1 << (p - 1))
    rank = clz32(rest) + 1
    return reg, rank


def build_bucket_hlls(ids: torch.Tensor, bucket_ids: torch.Tensor,
                      num_buckets: int, m: int,
                      seed: int = 0) -> torch.Tensor:
    """One pass: per-bucket HLL registers as ``(num_buckets, m)`` int32.

    ``amax`` scatter over the flattened key ``bucket * m + register`` onto
    zeros (empty registers stay 0) — Algorithm 1 line 4 of the paper.
    """
    reg, rank = point_register_rank(ids, m, seed)
    seg = bucket_ids.to(torch.int64) * m + reg
    flat = torch.zeros(num_buckets * m, dtype=torch.int32, device=ids.device)
    flat.scatter_reduce_(0, seg, rank, "amax")
    return flat.reshape(num_buckets, m)


def merge_registers(registers: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Merge HLLs (component-wise max) along ``axis`` — Algorithm 2 line 2."""
    return torch.amax(registers, dim=axis)


def _alpha(m: int) -> float:
    if m <= 16:
        return 0.673
    if m <= 32:
        return 0.697
    if m <= 64:
        return 0.709
    return 0.7213 / (1.0 + 1.079 / m)


def estimate_cardinality(registers: torch.Tensor, m: int) -> torch.Tensor:
    """HLL estimator with small/large-range corrections, in float32.

    ``registers``: (..., m) integers.  Returns float32 estimates (...,).
    Every division is a true float32 division (``_fdiv``): PyTorch
    rewrites ``scalar / tensor`` as a reciprocal times the scalar, which
    rounds differently, and ``log(m / zeros)`` magnifies that near 1.
    """
    regs = registers.to(torch.float32)
    raw = _fdiv(_alpha(m) * m * m, torch.sum(torch.exp2(-regs), dim=-1))
    zeros = torch.sum((registers == 0).to(torch.float32), dim=-1)
    # Small-range (linear counting) correction.
    small = m * torch.log(_fdiv(m, torch.clamp(zeros, min=1e-9)))
    est = torch.where((raw <= 2.5 * m) & (zeros > 0), small, raw)
    # Large-range correction for the 32-bit hash space.
    two32 = float(np.float32(2.0**32))
    large = float(np.float32(two32) / np.float32(30.0))
    return torch.where(est > large,
                       -two32 * torch.log1p(_fdiv(-est, two32)), est)


def _fdiv(a, b) -> torch.Tensor:
    """True float32 division; either side may be a Python number."""
    t = b if isinstance(b, torch.Tensor) else a
    if not isinstance(a, torch.Tensor):
        a = torch.tensor(a, dtype=torch.float32, device=t.device)
    if not isinstance(b, torch.Tensor):
        b = torch.tensor(b, dtype=torch.float32, device=t.device)
    return torch.div(a, b)


def estimate_from_registers(registers: torch.Tensor) -> torch.Tensor:
    """Convenience wrapper inferring m from the trailing dim."""
    return estimate_cardinality(registers, int(registers.shape[-1]))


def relative_error(m: int) -> float:
    """Theoretical standard relative error, 1.04 / sqrt(m) (paper Sec. 2)."""
    return 1.04 / float(np.sqrt(m))
