"""The SimHash fingerprint kernel (``csrc/simhash.cu``).

(N, d) points x (d, L * words * 32) zero-padded projections -> the sign
bits of x @ R packed LSB-first into (N, L, words) 32-bit words.  Replaces
``repro.kernels.simhash.simhash_pallas``; its plain version is
``ref.simhash_fingerprint``, and ``ops.simhash_fingerprint`` chooses
between them by device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["simhash", "lanes_per_word"]

_P = ctypes.c_void_p
_I = ctypes.c_int


def lanes_per_word(k: int) -> int:
    """Lane columns the kernel gives each word of a k-bit table: the power
    of two at or above k up to 32, and 32 when a table has more words."""
    return 32 if k > 16 else 1 << (k - 1).bit_length()


def simhash(x: torch.Tensor, r_padded: torch.Tensor, L: int,
            k: int) -> torch.Tensor:
    """(N, d) float32 x (d, L * words * 32) float32, each table's k
    columns zero-padded to ``words = ceil(k / 32)`` words -> (N, L, words)
    int32 bit views of the packed fingerprint words."""
    n, d = x.shape
    words = (k + 31) // 32
    tw = L * words
    _build.check(x, "x", torch.float32, (n, d))
    _build.check(r_padded, "r_padded", torch.float32, (d, tw * 32))
    if d < 1 or k < 1:
        raise ValueError("simhash needs d >= 1 and k >= 1")
    out = torch.empty((n, L, words), dtype=torch.int32, device=x.device)
    if n == 0 or tw == 0:
        return out
    _build.launch("simhash", "simhash", [_P, _P, _P, _I, _I, _I, _I, _P],
                  x.data_ptr(), r_padded.data_ptr(), out.data_ptr(), n, d,
                  tw, lanes_per_word(k), _build.stream(x))
    simhash.launches += 1
    return out


simhash.launches = 0
