"""LSH families used by the paper, in PyTorch.

The paper evaluates four (metric, family) pairs:

  * cosine   -> SimHash (Charikar'02)            [Webspam]
  * L2       -> p-stable Gaussian (Datar+'04)    [Corel]
  * L1       -> p-stable Cauchy (Datar+'04)      [CoverType]
  * Hamming  -> bit sampling (Indyk-Motwani'98)  [MNIST via 64-bit SimHash]

Each family produces, for every point, L table codes.  Codes are packed
into ``(…, L, W)`` 32-bit words (W = ceil(bits_per_code / 32)), carried
as int64 tensors holding uint32 values, then mixed into a bucket id in
``[0, num_buckets)``.  Parameters are plain dicts of tensors drawn from
a ``torch.Generator`` (or handed in by ``repro_torch.interop``).

``bucket_ids`` on a CUDA tensor runs everything after the projection's
matmul as one launch of the bucket hash kernel
(``repro_torch.kernels.bucket_hash``), whose front end the family picks
(the sign bits, the p-stable floor, or words it packed itself); on a CPU
or meta tensor, or with ``impl="ref"``, it runs the plain chain below.
Both give the same ids, bit for bit.  A CUDA tensor takes the kernel or
raises: nothing falls back.

Parameterization follows the paper: L is fixed, and
``k = ceil(log(1 - delta**(1/L)) / log(p1))`` for SimHash / bit sampling
(footnote 1, also used by E2LSH); for the p-stable families the paper
fixes (k, w) = (8, 4r) for L1 and (7, 2r) for L2 to reach delta = 10%.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional

import torch

from repro_torch.core.hll import hash32
from repro_torch.kernels import bucket_hash as _bh
from repro_torch.kernels import ops as _ops
from repro_torch.u32 import MASK32, as_u32

__all__ = [
    "SimHash", "PStableL2", "PStableL1", "BitSampling",
    "k_from_delta", "make_family", "bucket_fn_for", "uses_kernel",
    "mix_words",
]


def bucket_fn_for(family, num_buckets: int, impl: Optional[str] = None):
    """``(params, x) -> bucket ids`` for one (family, B, impl)."""
    return functools.partial(family.bucket_ids, num_buckets=num_buckets,
                             impl=impl)


def uses_kernel(device, impl: Optional[str] = None) -> bool:
    """Whether ``bucket_ids`` of a tensor on ``device`` runs the bucket
    hash kernel (``ops.resolve_impl``: a CUDA tensor unless ``impl="ref"``;
    raises for ``impl="cuda"`` off the card)."""
    return _ops.resolve_impl(impl, device) == "cuda"


def mix_words(words: torch.Tensor, num_buckets: int,
              impl: Optional[str] = None) -> torch.Tensor:
    """(..., W) uint32 words (int64 values or int32 bit views) -> (...)
    int32 bucket ids: the kernel's words front on the card, else
    ``_mix_words_to_bucket``."""
    if uses_kernel(words.device, impl):
        return _bh.bucket_hash(words.to(torch.int64).contiguous(),
                               num_buckets, "words", k=words.shape[-1])
    return _mix_words_to_bucket(words, num_buckets)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack boolean bits (..., k) into (..., ceil(k/32)) uint32 words
    (int64 tensors holding [0, 2**32))."""
    k = bits.shape[-1]
    w = (k + 31) // 32
    pad = w * 32 - k
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    bits = bits.reshape(bits.shape[:-1] + (w, 32)).to(torch.int64)
    powers = torch.ones(32, dtype=torch.int64, device=bits.device) \
        << torch.arange(32, dtype=torch.int64, device=bits.device)
    return torch.sum(bits * powers, dim=-1)


def _mix_words_to_bucket(words: torch.Tensor, num_buckets: int,
                         seed: int = 17) -> torch.Tensor:
    """Mix (..., W) uint32 words into an int32 bucket id in
    [0, num_buckets).  num_buckets must be a power of two."""
    if num_buckets & (num_buckets - 1):
        raise ValueError(f"num_buckets must be 2^t, got {num_buckets}")
    words = as_u32(words)
    acc = torch.full(words.shape[:-1], seed, dtype=torch.int64,
                     device=words.device)
    for j in range(words.shape[-1]):
        acc = hash32(acc ^ words[..., j], seed=seed + j)
    return (acc & (num_buckets - 1)).to(torch.int32)


def k_from_delta(p1: float, L: int, delta: float) -> int:
    """Paper footnote 1: smallest k with (1 - p1^k)^L <= delta."""
    if not (0.0 < p1 < 1.0):
        raise ValueError(f"p1 must be in (0,1), got {p1}")
    return max(1, math.ceil(math.log(1.0 - delta ** (1.0 / L)) / math.log(p1)))


def _norm_cdf(x: float) -> float:
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def _draw(shape, gen: torch.Generator, device, fn) -> torch.Tensor:
    """Draw on the generator's device, then move to ``device``."""
    return fn(shape, generator=gen, device=gen.device).to(device)


@dataclasses.dataclass(frozen=True)
class SimHash:
    """Random-hyperplane LSH for cosine distance (1 - cos theta)."""

    d: int
    L: int
    k: int
    metric: str = "cosine"
    host_syncs = 0   # blocking host->device copies of a plain bucket_ids

    def init(self, gen: torch.Generator, device=None) -> Dict[str, torch.Tensor]:
        r = _draw((self.d, self.L * self.k), gen, device,
                  functools.partial(torch.randn, dtype=torch.float32))
        return {"R": r}

    def codes(self, params, x: torch.Tensor) -> torch.Tensor:
        """x: (n, d) -> packed codes (n, L, W) uint32 (int64 tensor)."""
        proj = x.to(torch.float32) @ params["R"]
        bits = (proj > 0).reshape(x.shape[0], self.L, self.k)
        return _pack_bits(bits)

    def margins(self, params, x: torch.Tensor) -> torch.Tensor:
        """|projection| per bit — used by query-directed multiprobe."""
        proj = x.to(torch.float32) @ params["R"]
        return torch.abs(proj).reshape(x.shape[0], self.L, self.k)

    def bucket_ids(self, params, x: torch.Tensor, num_buckets: int,
                   impl: Optional[str] = None) -> torch.Tensor:
        """x: (n, d) -> (n, L) int32 bucket ids."""
        proj = x.to(torch.float32) @ params["R"]
        if uses_kernel(proj.device, impl):
            return _bh.bucket_hash(proj, num_buckets, "sign", k=self.k)
        bits = (proj > 0).reshape(x.shape[0], self.L, self.k)
        return _mix_words_to_bucket(_pack_bits(bits), num_buckets)

    def p1(self, r: float) -> float:
        """Collision prob of ONE bit for points at cosine distance r."""
        theta = math.acos(max(-1.0, min(1.0, 1.0 - r)))
        return 1.0 - theta / math.pi

    def p1_code(self, r: float) -> float:
        return self.p1(r) ** self.k


@dataclasses.dataclass(frozen=True)
class _PStableBase:
    """floor((a.x + b) / w) family (Datar et al. '04)."""

    d: int
    L: int
    k: int
    w: float
    metric: str = "l2"
    # the plain ``codes`` copies its float32 divisor w to the device; the
    # kernel takes w as an argument and copies nothing
    host_syncs = 1

    def _draw_a(self, gen, device):  # overridden: gaussian vs cauchy
        raise NotImplementedError

    def init(self, gen: torch.Generator, device=None) -> Dict[str, torch.Tensor]:
        a = self._draw_a(gen, device)
        b = _draw((self.L * self.k,), gen, device,
                  functools.partial(torch.rand, dtype=torch.float32)) * self.w
        return {"a": a, "b": b}

    def codes(self, params, x: torch.Tensor) -> torch.Tensor:
        """x: (n, d) -> (n, L, k) int32 lattice coordinates as uint32
        words (int64 tensor; negative floors wrap as an int32 -> uint32
        cast does)."""
        return self._floors(x.to(torch.float32) @ params["a"], params)

    def _floors(self, proj: torch.Tensor, params) -> torch.Tensor:
        proj = proj + params["b"]
        # a true float32 division: a Python scalar divisor would become a
        # reciprocal multiply on CUDA and move points across floors
        proj = proj / torch.tensor(self.w, dtype=torch.float32,
                                   device=proj.device)
        h = torch.floor(proj).to(torch.int64) & MASK32
        return h.reshape(proj.shape[0], self.L, self.k)

    def bucket_ids(self, params, x: torch.Tensor, num_buckets: int,
                   impl: Optional[str] = None) -> torch.Tensor:
        """x: (n, d) -> (n, L) int32 bucket ids."""
        proj = x.to(torch.float32) @ params["a"]
        if uses_kernel(proj.device, impl):
            return _bh.bucket_hash(proj, num_buckets, "floor", k=self.k,
                                   b=params["b"], w=self.w)
        return _mix_words_to_bucket(self._floors(proj, params), num_buckets)

    def p1_code(self, r: float) -> float:
        return self.p1(r) ** self.k


@dataclasses.dataclass(frozen=True)
class PStableL2(_PStableBase):
    metric: str = "l2"

    def _draw_a(self, gen, device):
        return _draw((self.d, self.L * self.k), gen, device,
                     functools.partial(torch.randn, dtype=torch.float32))

    def p1(self, r: float) -> float:
        """Datar et al. Eq. for Gaussian p-stable at distance c=r."""
        t = self.w / max(r, 1e-12)
        return (1.0 - 2.0 * _norm_cdf(-t)
                - 2.0 / (math.sqrt(2.0 * math.pi) * t)
                * (1.0 - math.exp(-t * t / 2.0)))


@dataclasses.dataclass(frozen=True)
class PStableL1(_PStableBase):
    metric: str = "l1"

    def _draw_a(self, gen, device):
        # Standard Cauchy via tan of uniform.
        u = _draw((self.d, self.L * self.k), gen, device,
                  functools.partial(torch.rand, dtype=torch.float32))
        u = 1e-6 + u * (1.0 - 2e-6)
        return torch.tan(math.pi * (u - 0.5))

    def p1(self, r: float) -> float:
        t = self.w / max(r, 1e-12)
        return (2.0 * math.atan(t) / math.pi
                - math.log1p(t * t) / (math.pi * t))


@dataclasses.dataclass(frozen=True)
class BitSampling:
    """Bit sampling LSH for Hamming distance over packed binary codes.

    Input points are (n, W_in) 32-bit fingerprints of ``dim_bits`` bits,
    as int32 bit views or int64 tensors holding uint32 values (the paper
    uses 64-bit SimHash fingerprints of MNIST).
    """

    dim_bits: int
    L: int
    k: int
    metric: str = "hamming"
    host_syncs = 0   # blocking host->device copies of a plain bucket_ids

    def init(self, gen: torch.Generator, device=None) -> Dict[str, torch.Tensor]:
        pos = _draw((self.L * self.k,), gen, device,
                    functools.partial(torch.randint, 0, self.dim_bits,
                                      dtype=torch.int32))
        return {"pos": pos}

    def codes(self, params, x: torch.Tensor) -> torch.Tensor:
        """x: (n, W_in) -> (n, L, W) uint32 sampled-bit codes (int64)."""
        pos = params["pos"].to(torch.int64)
        word, bit = pos // 32, pos % 32
        bits = (as_u32(x)[:, word] >> bit) & 1
        bits = bits.reshape(x.shape[0], self.L, self.k).to(torch.bool)
        return _pack_bits(bits)

    def bucket_ids(self, params, x: torch.Tensor, num_buckets: int,
                   impl: Optional[str] = None) -> torch.Tensor:
        """x: (n, W_in) -> (n, L) int32 bucket ids."""
        return mix_words(self.codes(params, x), num_buckets, impl)

    def p1(self, r: float) -> float:
        return 1.0 - float(r) / float(self.dim_bits)

    def p1_code(self, r: float) -> float:
        return self.p1(r) ** self.k


def make_family(metric: str, *, d: int, L: int, r: float, delta: float = 0.1,
                k: int | None = None, w: float | None = None):
    """Build the family the paper pairs with ``metric`` at radius ``r``.

    SimHash / bit sampling derive k from (L, delta, p1(r)); the p-stable
    families use the paper's fixed (k, w) presets unless overridden.
    """
    if metric == "cosine":
        fam = SimHash(d=d, L=L, k=1)
        kk = k or k_from_delta(fam.p1(r), L, delta)
        return SimHash(d=d, L=L, k=kk)
    if metric == "hamming":
        fam = BitSampling(dim_bits=d, L=L, k=1)
        kk = k or k_from_delta(fam.p1(r), L, delta)
        return BitSampling(dim_bits=d, L=L, k=kk)
    if metric == "l2":
        return PStableL2(d=d, L=L, k=k or 7, w=w or 2.0 * r)
    if metric == "l1":
        return PStableL1(d=d, L=L, k=k or 8, w=w or 4.0 * r)
    raise ValueError(f"unknown metric {metric!r}")
