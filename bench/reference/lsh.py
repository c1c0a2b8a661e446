"""Plain reference of the index's integer stages, from first principles.

Frozen copies of the arithmetic the paper's index is defined by (arXiv
1607.06179 §3-4 and the repository's bucket mixing): SimHash bits and
p-stable lattice codes, the murmur3 mixing of a code into one of B
buckets, the HyperLogLog (register, rank) of a row id, and the HLL
estimator.  Nothing here imports the program under test.

Bucket ids come with their doubt.  The program projects in float32, so a
code coordinate whose float64 value lies within ``TOL`` of a decision
boundary (relative to the sum of the absolute terms that make it) may
fall either way there.  ``bucket_ids`` marks such (row, table) pairs and
gives the bucket the other side of the boundary would give, so the judge
can hold the program to an interval instead of guessing.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple

import torch

M32 = 0xFFFFFFFF
_C1, _C2, _GOLDEN = 0x85EBCA6B, 0xC2B2AE35, 0x9E3779B9
MIX_SEED = 17
# relative to sum_i |x_i p_i|: float32 sums in another order stay inside
TOL = 1e-5

CERTAIN, ONE_ALT, WILD = 0, 1, 2


def mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2**32 for h in [0, 2**32), without int64 overflow."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def hash32(x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Murmur3's fmix32 of (x + seed * golden), as int64 in [0, 2**32)."""
    h = ((x.to(torch.int64) & M32) + ((seed * _GOLDEN) & M32)) & M32
    h = h ^ (h >> 16)
    h = mul32(h, _C1)
    h = h ^ (h >> 13)
    h = mul32(h, _C2)
    return h ^ (h >> 16)


def mix(words: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """(..., W) uint32 words (int64) -> bucket id in [0, num_buckets)."""
    acc = torch.full(words.shape[:-1], MIX_SEED, dtype=torch.int64,
                     device=words.device)
    for j in range(words.shape[-1]):
        acc = hash32(acc ^ (words[..., j] & M32), seed=MIX_SEED + j)
    return acc & (num_buckets - 1)


def clz32(v: torch.Tensor) -> torch.Tensor:
    """Leading zeros of uint32 values held in int64 (32 for 0)."""
    n = torch.zeros_like(v)
    x = v.clone()
    for shift in (16, 8, 4, 2, 1):
        small = x < (1 << (32 - shift))
        n = n + small * shift
        x = torch.where(small, (x << shift) & M32, x)
    return torch.where(v == 0, torch.full_like(n, 32), n)


def register_rank(pos: torch.Tensor, m: int):
    """HLL (register, rank) of row ids: top log2(m) bits of hash32(id)
    pick the register, the leading zeros of the rest plus one the rank."""
    p = int(m).bit_length() - 1
    h = hash32(pos, 0)
    reg = h >> (32 - p)
    rest = ((h << p) & M32) | (1 << (p - 1))
    return reg, clz32(rest) + 1


def hll_interval(lo: torch.Tensor, hi: torch.Tensor, eps: float = 1e-5):
    """Least and greatest estimate over every register vector between
    ``lo`` and ``hi`` (elementwise).  The estimator is not monotone where
    it switches from linear counting to the raw estimate (at 2.5 m,
    compared in float32 by the index: ``eps`` of room), so each branch
    that some vector in the box can take gives its own range."""
    m = lo.shape[-1]
    alpha = (0.673 if m <= 16 else 0.697 if m <= 32 else 0.709 if m <= 64
             else 0.7213 / (1.0 + 1.079 / m))
    raw = lambda r: alpha * m * m / torch.sum(  # noqa: E731
        torch.exp2(-r.to(torch.float64)), dim=-1)
    raw_lo, raw_hi = raw(lo), raw(hi)
    z_hi = torch.sum(lo == 0, dim=-1).to(torch.float64)
    z_lo = torch.sum(hi == 0, dim=-1).to(torch.float64)
    small = lambda z: m * torch.log(m / z.clamp(min=1.0))  # noqa: E731
    can_small = (raw_lo <= 2.5 * m * (1 + eps)) & (z_hi > 0)
    can_raw = (raw_hi > 2.5 * m * (1 - eps)) | (z_lo == 0)
    inf = torch.full_like(raw_lo, float("inf"))
    est_lo = torch.minimum(torch.where(can_small, small(z_hi), inf),
                           torch.where(can_raw, raw_lo, inf))
    est_hi = torch.maximum(torch.where(can_small, small(z_lo), -inf),
                           torch.where(can_raw, raw_hi, -inf))
    two32 = 2.0 ** 32
    large = lambda e: torch.where(  # noqa: E731
        e > two32 / 30.0, -two32 * torch.log1p(-e.clamp(max=two32 - 1) / two32),
        e)
    return large(est_lo), large(est_hi)


def simhash_k(r: float, L: int, delta: float) -> int:
    """Bits per table: the least k with (1 - p1^k)^L <= delta, p1 the
    one-bit collision chance at cosine distance r (footnote 1)."""
    p1 = 1.0 - math.acos(max(-1.0, min(1.0, 1.0 - r))) / math.pi
    return max(1, math.ceil(math.log(1.0 - delta ** (1.0 / L))
                            / math.log(p1)))


def family_shape(cfg: dict, r: float) -> Dict[str, float]:
    """(k, w) of the configuration's family at radius r."""
    if cfg["family"] == "simhash":
        return {"k": simhash_k(r, cfg["L"], cfg["delta"]), "w": 0.0}
    if cfg["family"] == "pstable_l1":
        return {"k": int(cfg["k"]), "w": float(cfg["w_over_r"]) * r}
    raise ValueError(f"unknown family {cfg['family']!r}")


def draw_params(cfg: dict, r: float, gen: torch.Generator
                ) -> Dict[str, torch.Tensor]:
    """The family's random parameters, drawn on the generator's device:
    SimHash {R (d, L*k)} standard normal; p-stable L1 {a (d, L*k)
    standard Cauchy, b (L*k,) uniform on [0, w)}."""
    shp = family_shape(cfg, r)
    d, cols = cfg["d"], cfg["L"] * shp["k"]
    dev = gen.device
    if cfg["family"] == "simhash":
        return {"R": torch.randn((d, cols), generator=gen, device=dev)}
    u = torch.rand((d, cols), generator=gen, device=dev)
    u = 1e-6 + u * (1.0 - 2e-6)
    a = torch.tan(math.pi * (u - 0.5))
    b = torch.rand((cols,), generator=gen, device=dev) * shp["w"]
    return {"a": a, "b": b}


def round_mantissa(x: torch.Tensor, bits: int) -> torch.Tensor:
    """float32 values rounded to ``bits`` explicit mantissa bits (10:
    TF32, 7: bfloat16), round to nearest even, kept as float32."""
    i = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & M32
    drop = 23 - bits
    half = 1 << (drop - 1)
    lsb = (i >> drop) & 1
    i = ((i + half - 1 + lsb) >> drop) << drop
    i = torch.where(i >= 2 ** 31, i - 2 ** 32, i)
    return i.to(torch.int32).view(torch.float32)


class Hashes(NamedTuple):
    bucket: torch.Tensor   # (n, L) int64, the float64 side of each boundary
    flag: torch.Tensor     # (n, L) int8: CERTAIN, ONE_ALT or WILD
    alt: torch.Tensor      # (n, L) int64, the other side's bucket (ONE_ALT)


def _codes(cfg, params, x, r, precision):
    """Per (row, code coordinate): the value whose sign (SimHash) or floor
    (p-stable) makes the code, and the scale of its rounding error."""
    shp = family_shape(cfg, r)
    if precision == "float64":
        x = x.to(torch.float64)
        p = {k: v.to(torch.float64) for k, v in params.items()}
    else:                                      # the control: TF32 inputs
        x = round_mantissa(x, 10)
        p = {k: (round_mantissa(v, 10) if v.dim() == 2 else
                 v.to(torch.float32)) for k, v in params.items()}
    if cfg["family"] == "simhash":
        val = x @ p["R"]
        scale = x.abs() @ p["R"].abs() if precision == "float64" else None
        return val, scale, shp
    val = (x @ p["a"] + p["b"]) / shp["w"]
    scale = ((x.abs() @ p["a"].abs() + p["b"].abs()) / shp["w"]
             if precision == "float64" else None)
    return val, scale, shp


def _words(cfg, codes, L, k):
    """Integer codes (n, L*k) -> (n, L, W) uint32 words as the index packs
    them: SimHash bits LSB first in ceil(k/32) words; p-stable floors
    one word each (two's complement)."""
    n = codes.shape[0]
    if cfg["family"] == "simhash":
        bits = codes.reshape(n, L, k)
        w = (k + 31) // 32
        bits = torch.nn.functional.pad(bits, (0, w * 32 - k))
        bits = bits.reshape(n, L, w, 32)
        sh = torch.arange(32, device=codes.device)
        return torch.sum(bits << sh, dim=-1) & M32
    return codes.reshape(n, L, k) & M32


def bucket_ids(cfg: dict, params, x: torch.Tensor, r: float,
               precision: str = "float64", block: int = 65536) -> Hashes:
    """Bucket ids of rows ``x`` in every table.  ``precision="float64"``
    gives the reference with its doubt; ``"tf32"`` the control's point
    answer (TF32 inputs, float32 sums), with every flag CERTAIN."""
    L, B = cfg["L"], cfg["num_buckets"]
    outs = []
    for lo in range(0, x.shape[0], block):
        val, scale, shp = _codes(cfg, params, x[lo:lo + block], r, precision)
        k = int(shp["k"])
        n = val.shape[0]
        if cfg["family"] == "simhash":
            code = (val > 0).to(torch.int64)
            near = (val.abs() <= TOL * scale) if scale is not None else None
            other = 1 - code
        else:
            fl = torch.floor(val)
            code = fl.to(torch.int64)
            frac = val - fl
            near = (torch.minimum(frac, 1.0 - frac) <= TOL * scale
                    if scale is not None else None)
            other = torch.where(frac < 0.5, code - 1, code + 1)
        bucket = mix(_words(cfg, code, L, k), B)
        if near is None:
            z = torch.zeros((n, L), dtype=torch.int8, device=x.device)
            outs.append(Hashes(bucket, z, bucket.clone()))
            continue
        near = near.reshape(n, L, k)
        cnt = near.sum(-1)
        flipped = torch.where(near.reshape(n, L * k), other, code)
        alt = mix(_words(cfg, flipped, L, k), B)
        flag = torch.where(cnt == 0, CERTAIN,
                           torch.where(cnt == 1, ONE_ALT, WILD)).to(torch.int8)
        outs.append(Hashes(bucket, flag, alt))
    return Hashes(*(torch.cat([o[i] for o in outs]) for i in range(3)))
