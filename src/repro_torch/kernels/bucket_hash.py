"""The bucket hash kernel (``csrc/bucket_hash.cu``).

A batch's LSH projection (or its pre-packed code words) -> int32 bucket
ids in ``[0, num_buckets)``, in one launch: the code words are built in
registers and mixed with fmix32 as ``families._mix_words_to_bucket``
does, bit for bit.  It replaces no Pallas kernel: on the TPU, XLA fused
the reference's ``jnp`` chain (``repro/core/lsh/families.py``) into one
kernel; eager PyTorch runs the same chain as one launch an integer op.

The plain version is the families' own (``_pack_bits`` or the p-stable
floor, then ``_mix_words_to_bucket``); each family's ``bucket_ids``
chooses between the two by device (``families.uses_kernel``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

__all__ = ["bucket_hash"]

# how the code words are made: the sign bits of a SimHash projection, the
# p-stable lattice coordinates floor((proj + b) / w), or words given
_FRONTS = {"sign": 0, "floor": 1, "words": 2}

_P = ctypes.c_void_p
_I = ctypes.c_int


def bucket_hash(src: torch.Tensor, num_buckets: int, front: str, k: int,
                b: Optional[torch.Tensor] = None,
                w: Optional[float] = None) -> torch.Tensor:
    """Bucket ids of ``src``, contiguous on the card:

    * ``"sign"``: (n, L * k) float32 projection -> (n, L);
    * ``"floor"``: (n, L * k) float32 projection, ``b`` (L * k,) float32
      offsets and the float32 width ``w`` -> (n, L);
    * ``"words"``: (..., k) int64 words (uint32 values, or int32 bit views
      widened) -> (...).

    ``num_buckets`` must be a power of two."""
    if num_buckets < 1 or num_buckets & (num_buckets - 1):
        raise ValueError(f"num_buckets must be 2^t, got {num_buckets}")
    if front not in _FRONTS:
        raise ValueError(f"front must be one of {sorted(_FRONTS)}, got "
                         f"{front!r}")
    if k < 1:
        raise ValueError(f"bucket_hash needs k >= 1 inputs a group, got {k}")
    if front == "floor" and (b is None or w is None):
        raise ValueError("the floor front needs the offsets b and width w")
    if front == "words":
        _build.check(src, "src", torch.int64, (*src.shape[:-1], k))
        shape, L = tuple(src.shape[:-1]), 1
    else:
        n, width = src.shape
        if width % k:
            raise ValueError(f"a projection of {width} columns does not "
                             f"split into tables of k = {k}")
        _build.check(src, "src", torch.float32, (n, width))
        shape, L = (n, width // k), width // k
    if front == "floor":
        _build.check(b, "b", torch.float32, (L * k,))
    out = torch.empty(shape, dtype=torch.int32, device=src.device)
    if out.numel() == 0:
        return out
    _build.launch("bucket_hash", "bucket_hash",
                  [_I, _P, _P, ctypes.c_float, ctypes.c_longlong, _I, _I,
                   ctypes.c_uint, _P, _P],
                  _FRONTS[front], src.data_ptr(),
                  None if b is None else b.data_ptr(),
                  0.0 if w is None else float(w), out.numel(), k, L,
                  num_buckets - 1, out.data_ptr(), _build.stream(src))
    bucket_hash.launches += 1
    return out


bucket_hash.launches = 0
