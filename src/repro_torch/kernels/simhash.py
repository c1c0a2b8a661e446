"""The SimHash fingerprint kernel (``csrc/simhash.cu``).

(N, d) points x (d, L * words * 32) zero-padded projections -> the sign
bits of x @ R packed LSB-first into (N, L, words) 32-bit words.  Replaces
``repro.kernels.simhash.simhash_pallas``; its plain version is
``ref.simhash_fingerprint``, and ``ops.simhash_fingerprint`` chooses
between them by device.

The kernel computes only the family's real columns, in the order its
epilogue packs them: ``layout`` and ``compact_projection`` build that
order here, where the CPU tests reach it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

__all__ = ["simhash", "lanes_per_word", "Layout", "layout",
           "compact_columns", "compact_projection", "plan"]

_P = ctypes.c_void_p
_I = ctypes.c_int


def lanes_per_word(k: int) -> int:
    """Lane columns a word of a k-bit table needs: the power of two at or
    above k up to 32, and 32 when a table has more words.  The kernel
    gives a word ``4 * layout(L, k).npw`` columns: these, at least 4."""
    return 32 if k > 16 else 1 << (k - 1).bit_length()


class Layout(NamedTuple):
    """How the kernel cuts a family's columns.  A word takes ``npw``
    nibbles of 4 columns; a column group (a block's resident R, at most
    128 columns) ``wg`` words; each of a warp pair's two column halves
    ``wh`` whole words in ``nfw`` fragments of 8 columns; ``groups``
    groups cover the ``tw = L * words`` words."""
    npw: int
    wg: int
    wh: int
    nfw: int
    groups: int
    tw: int


def layout(L: int, k: int) -> Layout:
    tw = L * ((k + 31) // 32)
    npw = max(1, lanes_per_word(k) // 4)
    groups = -(-tw // (32 // npw))
    wg = -(-tw // groups)
    wh = -(-wg // 2)
    return Layout(npw, wg, wh, -(-wh * npw // 2), groups, tw)


@functools.lru_cache(maxsize=32)
def compact_columns(L: int, k: int) -> torch.Tensor:
    """The padded projection's column behind each compact column, -1 for
    a zero column: (groups, 16 nfw) int64.

    Compact column c of group y lies in half ``c // (8 nfw)`` and, within
    it, fragment ``f`` at column ``2 t + e`` (the m16n8k8 accumulator's
    lane t, register parity e).  Its slot ``s = 2 f + e`` holds nibble
    ``s % npw`` of the half's word ``s // npw``, and lane t bit
    ``4 (s % npw) + t`` of that word: so one sign ballot of a register is
    8 rows' nibbles of one slot."""
    lay = layout(L, k)
    c = torch.arange(16 * lay.nfw)
    half, f, n = c // (8 * lay.nfw), (c // 8) % lay.nfw, c % 8
    s = 2 * f + n % 2
    w, bit = s // lay.npw, 4 * (s % lay.npw) + n // 2
    y = torch.arange(lay.groups)[:, None]
    words = torch.clamp(lay.tw - y * lay.wg, max=lay.wg)   # each group's
    local = half * lay.wh + w
    real = (w < lay.wh) & (local < words)
    return torch.where(real, (y * lay.wg + local) * 32 + bit, -1)


@functools.lru_cache(maxsize=32)
def _columns_on(L: int, k: int, device: torch.device):
    """``compact_columns`` on ``device``, flat: the source columns (0 for
    a zero column) and a (C, 1) float32 mask of the real ones."""
    cols = compact_columns(L, k).reshape(-1)
    return (cols.clamp(min=0).to(device),
            (cols >= 0).to(torch.float32).reshape(-1, 1).to(device))


def compact_projection(r_padded: torch.Tensor, L: int, k: int) -> torch.Tensor:
    """(d, L * words * 32) padded projection -> (groups, 16 nfw, d)
    float32, each group's compact columns K-contiguous (the kernel's
    resident R), zero where ``compact_columns`` says -1.  Two kernels: a
    gather of R's columns as rows, and the mask."""
    lay = layout(L, k)
    cols, real = _columns_on(L, k, r_padded.device)
    picked = r_padded.to(torch.float32).T.index_select(0, cols) * real
    return picked.reshape(lay.groups, 16 * lay.nfw, r_padded.shape[0])


def simhash(x: torch.Tensor, r_padded: torch.Tensor, L: int, k: int,
            rc: torch.Tensor | None = None) -> torch.Tensor:
    """(N, d) float32 x (d, L * words * 32) float32, each table's k
    columns zero-padded to ``words = ceil(k / 32)`` words -> (N, L, words)
    int32 bit views of the packed fingerprint words.  ``rc``: the
    ``compact_projection`` of ``r_padded``, if the caller has it."""
    n, d = x.shape
    lay = layout(L, k)
    _build.check(x, "x", torch.float32, (n, d))
    _build.check(r_padded, "r_padded", torch.float32, (d, lay.tw * 32))
    if d < 1 or k < 1:
        raise ValueError("simhash needs d >= 1 and k >= 1")
    if rc is None:
        rc = compact_projection(r_padded, L, k)
    _build.check(rc, "rc", torch.float32, (lay.groups, 16 * lay.nfw, d))
    out = torch.empty((n, L, lay.tw // L), dtype=torch.int32, device=x.device)
    if n == 0:
        return out
    _build.launch("simhash", "simhash", [_P] * 3 + [_I] * 8 + [_P],
                  x.data_ptr(), rc.data_ptr(), out.data_ptr(), n, d, lay.tw,
                  lay.npw, lay.wg, lay.wh, lay.nfw, lay.groups,
                  _build.stream(x))
    simhash.launches += 1
    return out


def plan(x: torch.Tensor, L: int, k: int) -> dict:
    """The layout ``simhash`` launches for x (on the card) and an (L, k)
    family: the loader (``bulk``: whole-row tiles by TMA copies;
    ``chunk``: the cp.async ring of 32-column chunks), its copy width,
    n-fragments a warp's half, column groups, 64-row tiles, d-columns of
    R staged at once, ring stages, dynamic shared memory, resident blocks
    an SM and blocks a group."""
    lay = layout(L, k)
    keys = ("mode", "copy_floats", "n_fragments", "groups", "tiles", "panel",
            "stages", "smem_bytes", "blocks_per_sm", "blocks_per_group")
    out = (_I * len(keys))()
    fn = _build.load("simhash").simhash_plan
    fn.argtypes = [_P, _I, _I, _I, _I, ctypes.POINTER(_I)]
    fn.restype = _I
    err = fn(x.data_ptr(), x.shape[0], x.shape[1], lay.nfw, lay.groups, out)
    if err:
        raise RuntimeError(f"simhash_plan: cudaError {err}")
    got = dict(zip(keys, out))
    got["mode"] = ("bulk", "chunk")[got["mode"]]
    return got


simhash.launches = 0
