"""The fused query-route scan kernels (``csrc/fused_scan.cu``).

  * ``linear_scan_dot`` — the linear route for l2 and cosine: distance,
    threshold, report mask and ids in one pass over (Q, N).  Replaces
    ``repro.kernels.fused_scan.linear_scan_dot_pallas``.
  * ``linear_scan_l1`` — the same pass for L1 (sum of |q - x|, on the
    CUDA cores).  Replaces ``linear_scan_l1_pallas``.
  * ``linear_scan_hamming`` — the same pass over packed 32-bit codes
    (XOR + popcount), for every segment of a routed group in one launch,
    with the streaming index's live / external-id epilogue.  Replaces
    ``linear_scan_hamming_pallas``.
  * ``lsh_scan`` — the LSH route's verification: the candidates' sort,
    dedup, row gather, rowwise l2/l1/cosine/Hamming distance and threshold
    over the unsorted (Q, C) candidates, in one kernel.  Replaces
    ``lsh_scan_pallas`` and the sort in front of it.  The corpus is
    gathered from device memory, never staged whole on chip.

Their plain versions are ``ref.fused_linear_scan`` and ``torch.sort`` +
``ref.fused_lsh_scan``; ``ops`` chooses between them by device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import fused_linear_scan as fused_linear_scan_ref
from repro_torch.kernels.ref import fused_lsh_scan as fused_lsh_scan_ref

__all__ = ["linear_scan_dot", "linear_scan_l1", "linear_scan_hamming",
           "lsh_scan", "lsh_scan_plan", "l1_tile_plan", "dot_tile_plan",
           "fused_linear_scan_ref", "fused_lsh_scan_ref", "LSH_METRICS"]

LINEAR_MODES = {"l2": 0, "cosine": 1}
# "cosine_unit": cosine on corpus rows the caller scaled to unit length (the
# query rows are scaled in the kernel)
LSH_METRICS = {"l2": 0, "l1": 1, "cosine_unit": 2, "hamming": 3}
LSH_MAX_QUERIES = 65535   # lsh_scan's grid is (splits, Q): gridDim.y's limit

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def linear_scan_dot(thresh: float, q: torch.Tensor, x: torch.Tensor,
                    qn: torch.Tensor, xn: torch.Tensor, *, mode: str):
    """(Q, d) x (N, d) float32 -> (dists f32, mask bool, ids i32), (Q, N).

    ``mode`` "l2": distance ||q||^2 + ||x||^2 - 2 q.x clamped at 0, with
    ``qn``/``xn`` the squared norms; "cosine": 1 - q.x on rows the caller
    normalised (``qn``/``xn`` unread).  ``thresh`` is r^2 for l2.
    """
    nq, d = q.shape
    nn = x.shape[0]
    _build.check(q, "q", torch.float32, (nq, d))
    _build.check(x, "x", torch.float32, (nn, d))
    _build.check(qn, "qn", torch.float32, (nq,))
    _build.check(xn, "xn", torch.float32, (nn,))
    dist, mask, ids = _linear_outputs(nq, nn, q.device)
    if nq == 0 or nn == 0:
        return dist, mask, ids
    _build.launch("fused_scan", "linear_scan_dot",
                  [_P, _P, _P, _P, _F, _I, _P, _P, _P, _I, _I, _I, _P],
                  q.data_ptr(), x.data_ptr(), qn.data_ptr(), xn.data_ptr(),
                  float(thresh), LINEAR_MODES[mode], dist.data_ptr(),
                  mask.data_ptr(), ids.data_ptr(), nq, nn, d,
                  _build.stream(q))
    linear_scan_dot.launches += 1
    return dist, mask, ids


def _linear_outputs(nq: int, nn: int, dev):
    return (torch.empty((nq, nn), dtype=torch.float32, device=dev),
            torch.empty((nq, nn), dtype=torch.bool, device=dev),
            torch.empty((nq, nn), dtype=torch.int32, device=dev))


def linear_scan_l1(thresh: float, q: torch.Tensor, x: torch.Tensor):
    """(Q, d) x (N, d) float32 -> (dists f32, mask bool, ids i32), (Q, N):
    sum |q - x|, the mask ``dist <= thresh``."""
    nq, d = q.shape
    nn = x.shape[0]
    _build.check(q, "q", torch.float32, (nq, d))
    _build.check(x, "x", torch.float32, (nn, d))
    dist, mask, ids = _linear_outputs(nq, nn, q.device)
    if nq == 0 or nn == 0:
        return dist, mask, ids
    _build.launch("fused_scan", "linear_scan_l1",
                  [_P, _P, _F, _P, _P, _P, _I, _I, _I, _P],
                  q.data_ptr(), x.data_ptr(), float(thresh), dist.data_ptr(),
                  mask.data_ptr(), ids.data_ptr(), nq, nn, d,
                  _build.stream(q))
    linear_scan_l1.launches += 1
    return dist, mask, ids


class _HamSeg(ctypes.Structure):
    _fields_ = [("x", _P), ("live", _P), ("ext", _P), ("col", ctypes.c_int64),
                ("n", _I), ("tile0", _I)]


HAM_MAX_SEGMENTS = 64     # kHamMaxSegs: segments a launch of the Hamming scan


class _HamArgs(ctypes.Structure):
    _fields_ = [("q", _P), ("dist", _P), ("mask", _P), ("ids", _P),
                ("ld", ctypes.c_int64), ("thresh", _F), ("Q", _I), ("W", _I),
                ("nseg", _I), ("tiles", _I),
                ("seg", _HamSeg * HAM_MAX_SEGMENTS)]


def linear_scan_hamming(thresh: float, q: torch.Tensor, parts):
    """The linear route over a group of segments, in one launch: (Q, W)
    int32 bit views of packed uint32 query codes against each part's
    ``x`` (n_s, W) -> (dists f32, mask bool, ids i32), each (Q, sum n_s),
    part s in its own columns, in order.

    ``parts``: ``ref.ScanPart``s (x, live, ext).  The distance is the
    Hamming distance (exact in float32), the mask ``float(dist) <= thresh``
    and ``live[n]`` where the part has ``live``; ids are ``ext[n]`` where
    masked in and ``ref.EXT_SENTINEL`` elsewhere where the part has
    ``ext``, else the row index n.  The outputs are views of buffers whose
    rows are padded to a multiple of 4 columns, so that the kernel's
    16-byte stores stay aligned.
    """
    nq, w = q.shape
    _build.check(q, "q", torch.int32, (nq, w))
    if w < 1:
        raise ValueError("linear_scan_hamming needs at least one word per code")
    for p in parts:
        n = p.x.shape[0]
        _build.check(p.x, "x", torch.int32, (n, w))
        if p.live is not None:
            _build.check(p.live, "live", torch.bool, p.live.shape)
            if p.live.ndim != 1 or p.live.shape[0] < n:
                raise ValueError(f"live: want at least {n} entries")
        if p.ext is not None:
            _build.check(p.ext, "ext", torch.int32, p.ext.shape)
            if p.ext.ndim != 1 or p.ext.shape[0] < n:
                raise ValueError(f"ext: want at least {n} entries")
    total = sum(p.x.shape[0] for p in parts)
    ld = -(-total // 4) * 4
    dist, mask, ids = _linear_outputs(nq, ld, q.device)
    out = tuple(t[:, :total] for t in (dist, mask, ids))
    col = 0
    for lo in range(0, len(parts), HAM_MAX_SEGMENTS):
        group = parts[lo:lo + HAM_MAX_SEGMENTS]
        a = _HamArgs(q=q.data_ptr(), dist=dist.data_ptr(),
                     mask=mask.data_ptr(), ids=ids.data_ptr(), ld=ld,
                     thresh=float(thresh), Q=nq, W=w, nseg=len(group))
        rows = 0
        for i, p in enumerate(group):
            n = p.x.shape[0]
            a.seg[i] = _HamSeg(p.x.data_ptr(), _ptr(p.live), _ptr(p.ext),
                               col, n, 0)
            col += n
            rows += n
        if nq == 0 or rows == 0:
            continue
        _build.check_layout("fused_scan", "grouped_hamming_args_bytes", _HamArgs)
        _build.launch("fused_scan", "grouped_hamming_scan", [_P, _P],
                      ctypes.addressof(a), _build.stream(q))
        linear_scan_hamming.launches += 1
    return out


def _ptr(t):
    return None if t is None else t.data_ptr()


def lsh_scan(thresh: float, x: torch.Tensor, q: torch.Tensor,
             cands: torch.Tensor, *, metric: str):
    """Sort and verify (Q, C) int32 candidates -> (ids i32, dists f32,
    mask bool), each (Q, C).

    x: (n, d) corpus and q: (Q, d) queries, float32 — or int32 bit views
    of packed uint32 codes for "hamming"; for "cosine_unit" x holds unit
    rows.  ``cands`` in any order, each in [0, n] (sentinel = n; an id
    outside that range is never gathered, and the outputs are then
    unspecified).  ``ids`` is ``torch.sort(cands)``'s values; ``mask``
    marks each run's first slot whose row lies within ``thresh``.
    Distances of duplicate and sentinel slots are +inf and not part of
    the contract.  One launch for up to ``LSH_MAX_QUERIES`` queries (the
    grid's y extent); a larger Q takes one launch a slice of that many,
    each writing its rows of the same outputs.
    """
    nq, c = cands.shape
    n, d = x.shape
    dtype = torch.int32 if metric == "hamming" else torch.float32
    _build.check(x, "x", dtype, (n, d))
    _build.check(q, "q", dtype, (nq, d))
    _build.check(cands, "cands", torch.int32, (nq, c))
    dev = x.device
    ids = torch.empty((nq, c), dtype=torch.int32, device=dev)
    dist = torch.empty((nq, c), dtype=torch.float32, device=dev)
    mask = torch.empty((nq, c), dtype=torch.bool, device=dev)
    if c == 0:
        return ids, dist, mask
    for lo in range(0, nq, LSH_MAX_QUERIES):
        s = slice(lo, lo + LSH_MAX_QUERIES)
        _build.launch("fused_scan", "lsh_scan",
                      [_I, _P, _P, _P, _F, _P, _P, _P, _I, _I, _I, _I, _P],
                      LSH_METRICS[metric], x.data_ptr(), q[s].data_ptr(),
                      cands[s].data_ptr(), float(thresh), ids[s].data_ptr(),
                      dist[s].data_ptr(), mask[s].data_ptr(),
                      min(LSH_MAX_QUERIES, nq - lo), c, n, d,
                      _build.stream(x))
        lsh_scan.launches += 1
    return ids, dist, mask


def lsh_scan_plan(x: torch.Tensor, nq: int, c: int) -> dict:
    """The layout ``lsh_scan`` launches for the corpus ``x`` (on the card)
    and (nq, c) candidates: blocks a query (splits), ids a block owns
    (width), distinct ids a block holds at once, the gather's copy width in
    elements, lanes a row and dynamic shared memory in bytes."""
    return _plan("lsh_scan_plan", [_P, _I, _I, _I, _I],
                 (x.data_ptr(), nq, c, x.shape[0], x.shape[1]),
                 ("splits", "width", "distinct_at_once", "copy_elems",
                  "lanes_per_row", "smem_bytes"))


def l1_tile_plan(q: torch.Tensor, x: torch.Tensor) -> dict:
    """The layout ``linear_scan_l1`` / ``pairwise_l1`` launch for (q, x)
    on the card."""
    return _plan("l1_tile_plan", [_P, _P, _I, _I, _I],
                 (q.data_ptr(), x.data_ptr(), q.shape[0], x.shape[0],
                  x.shape[1]),
                 ("copy_floats", "panel", "stages", "smem_bytes", "groups",
                  "tiles", "blocks_per_sm", "blocks_per_group",
                  "query_sets_per_group"))


def dot_tile_plan(q: torch.Tensor, x: torch.Tensor) -> dict:
    """The layout ``linear_scan_dot`` / ``pairwise_dot`` launch for (q, x)
    on the card."""
    return _plan("dot_tile_plan", [_P, _P, _I, _I, _I],
                 (q.data_ptr(), x.data_ptr(), q.shape[0], x.shape[0],
                  x.shape[1]),
                 ("copy_floats", "n_fragments", "warps", "group", "groups", "tiles",
                  "panel", "stages", "smem_bytes", "blocks_per_sm",
                  "blocks_per_group", "k_split"))


def _plan(entry: str, argtypes, args, keys) -> dict:
    out = (_I * len(keys))()
    fn = getattr(_build.load("fused_scan"), entry)
    fn.argtypes = [*argtypes, ctypes.POINTER(_I)]
    fn.restype = _I
    err = fn(*args, out)
    if err:
        raise RuntimeError(f"{entry}: cudaError {err}")
    return dict(zip(keys, out))


linear_scan_dot.launches = 0
linear_scan_l1.launches = 0
linear_scan_hamming.launches = 0
lsh_scan.launches = 0
