"""The delta's collision test kernel (``csrc/delta_collide.cu``).

The streaming delta's per-(query, row) bucket equality over the rows it
holds, in one launch: the exact (collisions, distinct) counts of the
route estimate, or the LSH route's (Q, n) "collides in a probed column"
mask.  It replaces no Pallas kernel: on the TPU, XLA fused the
reference's ``jnp`` chain (``repro/streaming/delta.py``
``collision_stats``, ``search``) into one kernel; eager PyTorch ran the
same chain over all C + 1 slots as a (Q, C + 1, V) bool tensor and three
reductions.

The plain version is ``ref.delta_collide``; ``ops.delta_collide`` chooses
between the two by device.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

__all__ = ["delta_collide", "MODES"]

MODES = {"counts": 0, "mask": 1}
ROWS_PER_BLOCK = 1024   # kRowsPerBlock: more rows, and the counts add up

_P = ctypes.c_void_p
_I = ctypes.c_int


def delta_collide(qb: torch.Tensor, rb: torch.Tensor, live: torch.Tensor,
                  tidx: Optional[torch.Tensor] = None, mode: str = "counts"):
    """(Q, V) int32 query buckets against the (n, L) int32 buckets of n
    rows and their (n,) bool ``live`` flags, column v probing table
    ``tidx[v]`` ((V,) int32) or v, contiguous on the card:

    * ``"counts"`` -> (collisions, distinct), each (Q,) int32: the live
      (row, column) equalities, and the live rows equal in a column;
    * ``"mask"`` -> (Q, n) bool: row j is live and equal in a column.

    With no rows, the counts are zeros and the mask has no columns, and
    nothing launches."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    nq, v = qb.shape
    n, L = rb.shape
    _build.check(qb, "qb", torch.int32, (nq, v))
    _build.check(rb, "rb", torch.int32, (n, L))
    _build.check(live, "live", torch.bool, (n,))
    if tidx is not None:
        _build.check(tidx, "tidx", torch.int32, (v,))
    elif v != L:
        raise ValueError(f"{v} query columns need a column -> table map "
                         f"over the rows' {L} tables")
    if mode == "mask":
        out = torch.empty((nq, n), dtype=torch.bool, device=qb.device)
        ptrs = (None, None, out.data_ptr())
    else:
        # one chunk of rows stores its sums; more add theirs into zeros
        new = torch.empty if 0 < n <= ROWS_PER_BLOCK else torch.zeros
        both = new((2, nq), dtype=torch.int32, device=qb.device)
        out = (both[0], both[1])
        ptrs = (both[0].data_ptr(), both[1].data_ptr(), None)
    if nq and n:
        _build.launch("delta_collide", "delta_collide",
                      [_I, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
                      MODES[mode], qb.data_ptr(), rb.data_ptr(),
                      live.data_ptr(),
                      None if tidx is None else tidx.data_ptr(), nq, n, v, L,
                      *ptrs, _build.stream(qb))
        delta_collide.launches += 1
    return out


delta_collide.launches = 0
