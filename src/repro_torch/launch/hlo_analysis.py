"""Cost counting of what the port dispatches: the reference's
``repro.launch.hlo_analysis`` without HLO.

The reference re-derives FLOPs, HBM bytes and collective wire bytes from
a compiled step's optimized HLO.  The port compiles nothing, so
``CostCounter`` (a ``TorchDispatchMode``) counts the ATen ops a step
dispatches, on any device, the meta device included (shapes only: a
production step is counted without allocating it):

  * FLOPs: 2 * M * N * K for the matmul family (``mm``, ``addmm``,
    ``bmm``, ``baddbmm``, ``mv``, ``dot``; ``matmul``, ``einsum`` and
    ``linear`` reach the dispatcher as these), the reference's
    ``_dot_flops`` rule.  Elementwise work counts no FLOPs there either;
  * bytes: operand bytes plus result bytes of each op.  Views,
    ``detach`` and allocations (``empty``) count nothing, as the
    reference's ``bitcast`` / ``get-tuple-element`` do; an in-place
    update of a slice (``index_copy_``, ``index_put_``, ``scatter*_``,
    ``index_add_``, ``copy_``) counts its payload (every operand but the
    buffer it writes), the reference's ``inplace-update`` rule.  The
    count is unfused, so it is an upper bound on what a fusing compiler
    moves (XLA's post-fusion bytes);
  * loops: eager torch dispatches every iteration, so the count is
    loop-aware by construction (the reference's ``known_trip_count``
    multiplier has nothing to multiply), and a ``checkpoint``'s
    recomputation in the backward pass counts again;
  * collectives: ``ShardMesh.psum`` / ``pmax`` / ``pmin`` /
    ``all_gather`` / ``ppermute`` report to the active counters
    (``core.distributed.COLLECTIVE_OBSERVERS``), one shard's result bytes
    times the reference's ``_WIRE_FACTOR`` (all-reduce 2, the others 1),
    per shard, one count a call.  They are the port's only collectives
    (the ``shard_map`` sites); a layout constraint on one controller
    moves nothing, so GSPMD's own collectives (FSDP gathers, tensor-
    parallel reductions) have no counterpart here;
  * live bytes: the peak of the bytes of the storages alive at once, each
    storage once, over the step (in the place of ``memory_analysis``).
    The counter holds weak references only, so it keeps no tensor alive.

A single controller runs every shard's part, so FLOPs and bytes are the
whole step's (divide by the chips for an even split); wire bytes are per
shard, as in the reference's per-device module.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Callable, Dict, List

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.core import distributed as dist

__all__ = ["Costs", "CostCounter", "analyze_step"]

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")
_WIRE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}

aten = torch.ops.aten
# the operand holding the left matrix (its last dim is the contraction)
_MATMUL = {aten.mm: 0, aten.bmm: 0, aten.mv: 0, aten.dot: 0,
           aten.addmm: 1, aten.baddbmm: 1, aten.addmv: 1}
# no traffic of their own: aliases, allocations without a write
_FREE = {aten.detach, aten._unsafe_view, aten.alias, aten.lift_fresh,
         aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
         aten.new_empty_strided, aten._local_scalar_dense}
# in-place updates of a slice of their first operand: the payload counts
_INPLACE_UPDATE = {aten.index_copy_, aten.index_put_, aten._index_put_impl_,
                   aten.scatter_, aten.scatter_add_, aten.scatter_reduce_,
                   aten.index_add_, aten.copy_, aten.masked_scatter_}


@dataclasses.dataclass
class Costs:
    flops: float = 0.0
    bytes: float = 0.0
    wire: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {c: 0.0 for c in _COLLECTIVES})
    coll_counts: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {c: 0.0 for c in _COLLECTIVES})
    by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    peak_live_bytes: float = 0.0

    def _acc(self, op: str, b: float):
        self.bytes += b
        self.by_op[op] = self.by_op.get(op, 0.0) + b

    def add(self, other: "Costs", mult: float = 1.0):
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        for c in _COLLECTIVES:
            self.wire[c] += other.wire[c] * mult
            self.coll_counts[c] += other.coll_counts[c] * mult
        for k, v in other.by_op.items():
            self.by_op[k] = self.by_op.get(k, 0.0) + v * mult


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x) -> List[torch.Tensor]:
    """The tensors among an op's arguments or results (one level of
    lists, as ATen passes them)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def tensor_leaves(tree) -> List[torch.Tensor]:
    """Every tensor of a tree of dicts, lists, tuples, dataclasses and
    modules (their parameters and buffers)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, dict):
        tree = list(tree.values())
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensor_leaves(v)]
    return []


class CostCounter(TorchDispatchMode):
    """Counts FLOPs, bytes, collectives and live bytes into ``costs``
    while active: ``with CostCounter() as c: step(...)``; then
    ``c.costs``.  ``track(tree)`` counts tensors made before the counter
    (a step's arguments) as live from the start."""

    def __init__(self):
        super().__init__()
        self.costs = Costs()
        # each live storage -> the finalizer that subtracts its bytes
        self._seen = WeakIdKeyDictionary()
        self._live = 0
        self._depth = 0

    # ------------------------------------------------------ live bytes
    def _free(self, n: int) -> None:
        self._live -= n

    def track(self, tree) -> None:
        for t in tensor_leaves(tree):
            self._track(t)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._seen:
            return
        n = st.nbytes()
        self._seen[st] = weakref.finalize(st, self._free, n)
        self._live += n
        if self._live > self.costs.peak_live_bytes:
            self.costs.peak_live_bytes = float(self._live)

    # ----------------------------------------------------- collectives
    def collective(self, kind: str, result: torch.Tensor) -> None:
        self.costs.wire[kind] += _nbytes(result) * _WIRE_FACTOR[kind]
        self.costs.coll_counts[kind] += 1

    def __enter__(self):
        # the mode is entered again for each composite op it decomposes
        self._depth += 1
        if self._depth == 1:
            dist.COLLECTIVE_OBSERVERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        self._depth -= 1
        if self._depth == 0:
            dist.COLLECTIVE_OBSERVERS.remove(self)
            for f in list(self._seen.values()):
                f.detach()
        return super().__exit__(*exc)

    # -------------------------------------------------------- the ops
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        if packet not in _MATMUL:
            # a composite op (``einsum`` under ``inference_mode``) is
            # counted as the ops it decomposes into
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        outs = _tensors(out)
        for t in outs:
            self._track(t)
        if func.is_view or packet in _FREE:
            return out
        ins = _tensors(args) + _tensors(kwargs)
        for t in ins:
            self._track(t)
        lhs = _MATMUL.get(packet)
        if lhs is not None:
            k = args[lhs].shape[-1] if args[lhs].dim() else 1
            self.costs.flops += 2.0 * outs[0].numel() * k
        if packet in _INPLACE_UPDATE:
            self.costs._acc("inplace-update",
                            float(sum(_nbytes(t) for t in ins[1:])))
        else:
            self.costs._acc(packet.__name__, float(
                sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)))
        return out


def analyze_step(fn: Callable, *args, **kwargs) -> Costs:
    """The costs of one call ``fn(*args, **kwargs)``, its arguments live
    from the start.  The result is dropped inside the count (a step's
    outputs are live at its end)."""
    with CostCounter() as counter:
        counter.track((args, kwargs))
        fn(*args, **kwargs)
    return counter.costs
