"""Public wrappers around the kernels, with dispatch by device.

``impl`` selects what runs, as ``repro.kernels.ops``'s ``impl=`` does:

  * ``None``   — the CUDA kernel for a CUDA tensor, the plain version in
                 ``ref.py`` for a CPU tensor;
  * ``"ref"``  — the plain version on either device (``chip_smoke.py``
                 holds the kernels against it on the card);
  * ``"cuda"`` — the kernel; raises for a CPU tensor.

Nothing falls back: a kernel that fails to build or launch raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import fused_scan as _fs
from repro_torch.kernels import hll_merge as _hllm
from repro_torch.kernels import ref as _ref
from repro_torch.u32 import as_i32

__all__ = ["hll_merge_estimate", "pad_to", "metric_radius_transform",
           "fused_linear_scan", "fused_lsh_scan", "resolve_impl"]

IMPLS = ("ref", "cuda")


def resolve_impl(impl: Optional[str], device) -> str:
    """What an ``impl=`` request runs for tensors on ``device``:
    ``"cuda"`` (the kernel) or ``"ref"`` (the plain version)."""
    device = torch.device(device)
    if impl is None:
        return "cuda" if device.type == "cuda" else "ref"
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS} or None, got {impl!r}")
    if impl == "cuda" and device.type != "cuda":
        raise ValueError(f"impl='cuda' needs CUDA tensors, got {device}")
    return impl


def pad_to(x: torch.Tensor, mult: int, axis: int, value=0) -> torch.Tensor:
    """Pad ``axis`` of ``x`` up to a multiple of ``mult`` with ``value``."""
    size = x.shape[axis]
    pad = (-size) % mult
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    fill = torch.full(shape, value, dtype=x.dtype, device=x.device)
    return torch.cat([x, fill], dim=axis)


def metric_radius_transform(metric: str, r: float) -> float:
    """Map a user radius to the raw-kernel comparison value: the L2 scans
    return *squared* distances, so the threshold is r^2."""
    return r * r if metric == "l2" else r


def fused_linear_scan(q: torch.Tensor, x: torch.Tensor, r, metric: str,
                      impl: Optional[str] = None,
                      x_unit: Optional[torch.Tensor] = None):
    """Fused linear-route scan: distance + threshold + report mask +
    candidate ids in one kernel pass over (Q, N).

    q: (Q, d) queries; x: (N, d) corpus; r: report radius.  Returns
    (ids (Q, N) i32, dists (Q, N) f32, mask (Q, N) bool).  On CUDA the
    l2 and cosine metrics run the kernel; l1 and Hamming raise until
    their kernels are ported.  ``x_unit``: for cosine, x's rows already
    scaled to unit length (contiguous float32), which the kernel route
    reads instead of normalising x on every call; the plain version
    ignores it.
    """
    impl = resolve_impl(impl, q.device)
    thresh = metric_radius_transform(metric, r)
    if impl == "ref":
        return _ref.fused_linear_scan(q, x, thresh, metric)
    if metric not in _fs.LINEAR_MODES:
        raise NotImplementedError(
            f"no CUDA linear scan for metric {metric!r} yet: ROADMAP.md "
            "Queue 2 #4 (linear_scan_l1) / #5 (linear_scan_hamming)")
    q = q.to(torch.float32)
    x = x.to(torch.float32)
    if metric == "cosine":        # normalised rows; the norms go unread
        if x_unit is None:
            x_unit = _ref.unit_rows(x)
        q, x = _ref.unit_rows(q).contiguous(), x_unit.contiguous()
        qn, xn = q.new_empty(q.shape[0]), x.new_empty(x.shape[0])
    else:
        q, x = q.contiguous(), x.contiguous()
        qn, xn = torch.sum(q * q, dim=-1), torch.sum(x * x, dim=-1)
    dists, mask, ids = _fs.linear_scan_dot(thresh, q, x, qn, xn, mode=metric)
    return ids, dists, mask


def fused_lsh_scan(x: torch.Tensor, ids_sorted: torch.Tensor,
                   q: torch.Tensor, r, metric: str,
                   impl: Optional[str] = None):
    """Fused LSH-route candidate verification: sorted-run dedup + row
    gather + rowwise distance + threshold in one kernel pass over the
    (Q, C) candidates.

    x: (n, d) corpus (packed 32-bit codes for hamming); ids_sorted:
    (Q, C) *sorted* candidate ids with sentinel = n; q: (Q, d).  Returns
    (ids (Q, C) i32, dists (Q, C) f32, mask (Q, C) bool) with duplicates,
    sentinels and out-of-radius rows masked.
    """
    impl = resolve_impl(impl, x.device)
    thresh = metric_radius_transform(metric, r)
    prev = torch.cat([torch.full(ids_sorted.shape[:-1] + (1,), -1,
                                 dtype=ids_sorted.dtype,
                                 device=ids_sorted.device),
                      ids_sorted[..., :-1]], dim=-1)
    if impl == "ref":
        return _ref.fused_lsh_scan(x, ids_sorted, prev, q, thresh, metric)
    if metric == "hamming":
        x, q = as_i32(x), as_i32(q)
    else:
        x, q = x.to(torch.float32), q.to(torch.float32)
    dists, mask = _fs.lsh_scan(
        thresh, x.contiguous(), q.contiguous(),
        ids_sorted.to(torch.int32).contiguous(),
        prev.to(torch.int32).contiguous(), metric=metric)
    return ids_sorted, dists, mask


def hll_merge_estimate(regs: torch.Tensor,
                       impl: Optional[str] = None) -> torch.Tensor:
    """(Q, L, m) uint8 registers -> (Q,) float32 candSize estimates."""
    if resolve_impl(impl, regs.device) == "ref":
        return _ref.hll_merge_estimate(regs)
    return _hllm.hll_merge_estimate(regs)
