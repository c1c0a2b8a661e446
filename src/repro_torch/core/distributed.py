"""Row-sharded Hybrid LSH index on one controller (beyond the paper).

The database is row-sharded over the shards of a ``ShardMesh``.  Each
shard builds *local* CSR tables over its rows with globally-unique ids.
At query time every shard wraps its tables in the engine's
``TableSegment`` and the shards' ``SegmentEstimate`` terms are merged:

  * global #collisions = psum of the shards' live collisions;
  * global candSize    = HLL estimate of the pmax-merged registers: HLL
    mergeability, which the paper uses across L tables, extends verbatim
    across shards, so one (Q, m) pmax is the whole estimate;
  * routing policies:
      - "global":    one decision from the global Eq. (1)/(2) costs;
      - "per_shard": each shard compares ITS local costs and picks its
        own strategy.  Correct because r-NN reporting is a union over
        disjoint shards; better under local density skew (the shard
        holding a dense cluster scans linearly while the others use LSH).

One process drives every shard (a single controller, as the reference's
``shard_map`` does): a ``ShardMesh`` holds one ``torch.device`` per shard,
and ``psum`` / ``pmax`` are reductions over the shards' tensors on the
first shard's device (moves between shards on one device cost nothing).
Not ``torch.distributed``: the reference's API returns every shard's
(S, Q, max_out) buffers from one call, and NCCL refuses two ranks on one
GPU, where a 4-shard deployment mapped onto one card has all four.  Each
shard takes its route on the host (the reference's ``lax.cond``).

The estimate's terms come from ``QueryEngine.segment_terms`` (K3 in its
terms mode, one launch a shard), the searches from
``QueryEngine.search_group``; the streaming variant is
``streaming.sharded``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.cost_model import CostModel
from repro_torch.core.engine import (QueryEngine, RouteEstimate,
                                     SegmentEstimate, TableSegment,
                                     compact_results, finalize_route)
from repro_torch.core.index import as_rows
from repro_torch.core.lsh.families import bucket_fn_for
from repro_torch.core.lsh.tables import LSHTables, build_tables
from repro_torch.kernels.ref import unit_rows

__all__ = ["ShardMesh", "make_mesh", "ShardedIndexState", "build_sharded",
           "make_query_fn", "prefers_lsh", "stack_shards"]

_HASH_CHUNK = 65536
# Observers of the collectives below (``launch.hlo_analysis``'s counter
# while it is active): each is told a collective's kind, in the
# reference's HLO names, and one shard's result.
COLLECTIVE_OBSERVERS: List = []


def _observed(kind: str, out: List[torch.Tensor]) -> List[torch.Tensor]:
    for obs in COLLECTIVE_OBSERVERS:
        obs.collective(kind, out[0])
    return out


class ShardMesh:
    """One ``torch.device`` per shard, over one or more named axes.

    ``ShardMesh(devices, "data")`` is a one-axis mesh of ``len(devices)``
    shards; ``ShardMesh(devices, ("data", "model"), (4, 2))`` a 4 x 2
    one, the shards in row-major order of the coordinates (shard i at
    ``coords(i)``), as for the reference's ``jax.sharding.Mesh``:
    ``mesh.shape[name]`` is an axis's size.

    The collectives take one tensor per shard and return one per shard,
    on its device.  Over ``names`` (a name, a tuple of names, or None for
    every axis) the shards that share their coordinates on the other
    axes form a group; each group reduces in the order of its ranks along
    ``names`` (``axis_index``) on its first shard's device."""

    def __init__(self, devices: Sequence, axis: Union[str, Sequence[str]]
                 = "data", shape: Optional[Sequence[int]] = None):
        self.devices = tuple(torch.device(d) for d in devices)
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        sizes = ((len(self.devices),) if shape is None
                 else tuple(int(n) for n in shape))
        if len(names) != len(sizes) or len(set(names)) != len(names):
            raise ValueError(f"axes {names} do not name the {len(sizes)} "
                             f"dimensions of the shape {sizes} once each")
        if not self.devices or math.prod(sizes) != len(self.devices):
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"shape {sizes}")
        self.axis_names, self._sizes = names, sizes
        # the one-axis meshes of the sharded indexes name their axis here
        self.axis = names[0] if len(names) == 1 else None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self._sizes))

    @property
    def size(self) -> int:
        return len(self.devices)

    def _names(self, names) -> Tuple[str, ...]:
        if names is None:
            return self.axis_names
        names = (names,) if isinstance(names, str) else tuple(names)
        for n in names:
            if n not in self.axis_names:
                raise KeyError(f"axis {n!r} is not in the mesh "
                               f"{self.axis_names}")
        return names

    def axis_size(self, names=None) -> int:
        """The product of the sizes of ``names`` (1 for none)."""
        return math.prod(self.shape[n] for n in self._names(names))

    def coords(self, shard: int) -> Dict[str, int]:
        """Shard ``shard``'s index along each axis (row-major)."""
        out = {}
        for n, size in zip(reversed(self.axis_names), reversed(self._sizes)):
            shard, out[n] = divmod(shard, size)
        return {n: out[n] for n in self.axis_names}

    def axis_index(self, shard: int, names=None) -> int:
        """Shard ``shard``'s rank over ``names``, row-major in the order
        given (the reference's ``rank * size + axis_index`` loop)."""
        c, rank = self.coords(shard), 0
        for n in self._names(names):
            rank = rank * self.shape[n] + c[n]
        return rank

    def groups(self, names=None) -> List[List[int]]:
        """The shards that reduce together over ``names``, each group in
        rank order."""
        names = self._names(names)
        out: Dict[tuple, List[int]] = {}
        for i in range(self.size):
            c = self.coords(i)
            out.setdefault(tuple(c[n] for n in self.axis_names
                                 if n not in names), []).append(i)
        return [sorted(g, key=lambda i: self.axis_index(i, names))
                for g in out.values()]

    def sub(self, names) -> "ShardMesh":
        """The mesh of ``names`` alone (in the order given): the shards
        at coordinate 0 on every other axis."""
        names = self._names(names)
        g = next(g for g in self.groups(names)
                 if all(self.coords(g[0])[n] == 0 for n in self.axis_names
                        if n not in names))
        return ShardMesh([self.devices[i] for i in g], names,
                         [self.shape[n] for n in names])

    def _check(self, tensors: Sequence) -> None:
        if len(tensors) != self.size:
            raise ValueError(f"{len(tensors)} tensors for {self.size} shards")

    def _reduce(self, tensors: Sequence[torch.Tensor], op, names=None
                ) -> List[torch.Tensor]:
        self._check(tensors)
        out: List[Optional[torch.Tensor]] = [None] * self.size
        for g in self.groups(names):
            home = self.devices[g[0]]
            acc = tensors[g[0]].to(home)
            for i in g[1:]:
                acc = op(acc, tensors[i].to(home))
            for i in g:
                out[i] = acc.to(self.devices[i])
        return _observed("all-reduce", out)

    def psum(self, tensors: Sequence[torch.Tensor], names=None
             ) -> List[torch.Tensor]:
        """Sum over ``names``, in rank order."""
        return self._reduce(tensors, torch.add, names)

    def pmax(self, tensors: Sequence[torch.Tensor], names=None
             ) -> List[torch.Tensor]:
        """Elementwise max over ``names``."""
        return self._reduce(tensors, torch.maximum, names)

    def pmin(self, tensors: Sequence[torch.Tensor], names=None
             ) -> List[torch.Tensor]:
        """Elementwise min over ``names``."""
        return self._reduce(tensors, torch.minimum, names)

    def all_gather(self, tensors: Sequence[torch.Tensor], names=None
                   ) -> List[torch.Tensor]:
        """Each shard gets its group's tensors stacked on a new leading
        axis, in rank order."""
        self._check(tensors)
        out: List[Optional[torch.Tensor]] = [None] * self.size
        for g in self.groups(names):
            home = self.devices[g[0]]
            stacked = torch.stack([tensors[i].to(home) for i in g])
            for i in g:
                out[i] = stacked.to(self.devices[i])
        return _observed("all-gather", out)

    def ppermute(self, tensors: Sequence[torch.Tensor], names,
                 perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
        """Within each group over ``names``, rank ``src`` sends its tensor
        to rank ``dst`` for each (src, dst) of ``perm``; a shard that
        receives nothing gets zeros (``lax.ppermute``)."""
        self._check(tensors)
        out = [torch.zeros_like(t) for t in tensors]
        for g in self.groups(names):
            for src, dst in perm:
                out[g[dst]] = tensors[g[src]].to(self.devices[g[dst]])
        return _observed("collective-permute", out)

    def __repr__(self) -> str:
        return (f"ShardMesh({[str(d) for d in self.devices]}, "
                f"shape={self.shape})")


def make_mesh(shards: int, device="cuda", axis: str = "data") -> ShardMesh:
    """A mesh of ``shards`` shards on ``device`` ("cuda" unless the caller
    asks for the CPU; raises without CUDA).  Plain "cuda" puts shard s on
    ``cuda:{s % device_count}``, so one card holds every shard; a device
    with an index (or the CPU) holds them all."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run the shards on the CPU")
        if dev.index is None:
            count = torch.cuda.device_count()
            return ShardMesh([torch.device("cuda", s % count)
                              for s in range(int(shards))], axis)
    return ShardMesh([dev] * int(shards), axis)


def prefers_lsh(route: RouteEstimate, nq: int) -> bool:
    """One shard's strategy for the whole batch: LSH when the batch's
    summed Eq. (1) costs undercut Eq. (2) for every query (the
    reference's ``use_lsh`` scalar before its ``lax.cond``)."""
    return bool(torch.sum(route.lsh_cost) < route.linear_cost * nq)


def stack_shards(mesh: ShardMesh, per_shard: Sequence[tuple]):
    """Per-shard ``(ids, dists, mask)`` -> three (S, ...) tensors on the
    mesh's first device."""
    home = mesh.devices[0]
    return tuple(torch.stack([p[i].to(home) for p in per_shard])
                 for i in range(3))


@dataclasses.dataclass
class ShardedIndexState:
    """Each shard's leaves, on its own device (lists indexed by shard)."""

    x: List[torch.Tensor]          # (n/S, d) rows, a contiguous block each
    perm: List[torch.Tensor]       # (L, n/S) local row indices
    starts: List[torch.Tensor]     # (L, B + 1)
    registers: List[torch.Tensor]  # (L, B, m), keyed on global ids
    x_unit: Optional[List[torch.Tensor]] = None   # cosine on CUDA: unit rows

    def local_tables(self, s: int) -> LSHTables:
        return LSHTables(self.perm[s], self.starts[s], self.registers[s])


def build_sharded(family, params, x, *, num_buckets: int, m: int,
                  mesh: ShardMesh, data_axis: str = "data"
                  ) -> ShardedIndexState:
    """Build per-shard tables; shard s holds rows [s n/S, (s + 1) n/S).

    HLLs hash GLOBAL ids (the cross-shard distinct union); the CSR perm
    stores LOCAL row indices so the search gathers local rows, and the
    query re-offsets what it reports."""
    n = int(x.shape[0])
    shards = mesh.shape[data_axis]
    if n % shards:
        raise ValueError(f"{n} rows do not split over {shards} shards")
    n_local = n // shards
    bucket_fn = bucket_fn_for(family, num_buckets)
    xs, perms, starts, regs, units = [], [], [], [], []
    for s, dev in enumerate(mesh.devices):
        rows = as_rows(x[s * n_local:(s + 1) * n_local], family.metric, dev)
        p = {k: v.to(dev) for k, v in params.items()}
        bids = torch.cat([bucket_fn(p, rows[lo:lo + _HASH_CHUNK])
                          for lo in range(0, max(n_local, 1), _HASH_CHUNK)])
        ids = s * n_local + torch.arange(n_local, dtype=torch.int32,
                                         device=dev)
        t = build_tables(ids, bids, num_buckets, m)
        xs.append(rows)
        perms.append(t.perm - s * n_local)
        starts.append(t.starts)
        regs.append(t.registers)
        if family.metric == "cosine" and dev.type == "cuda":
            units.append(unit_rows(rows).contiguous())
    return ShardedIndexState(x=xs, perm=perms, starts=starts, registers=regs,
                             x_unit=units or None)


def make_query_fn(family, *, num_buckets: int, mesh: ShardMesh,
                  n_total: int, cost_model: CostModel, metric: str, cap: int,
                  max_out: int, policy: str = "per_shard",
                  data_axis: str = "data"):
    """The distributed hybrid query: fn(state, params, queries, r,
    force=None) -> dict(ids (S, Q, max_out), dists, mask (tensors on the
    mesh's first device), collisions (Q,), cand_est (Q,), used_lsh (S,)
    numpy bool).  ``force`` ("lsh" / "linear") overrides the policy.

    ``ids`` are global row ids (shard s offsets its rows by s n/S); the
    report of query i is the union over the shard axis of ``mask``.
    ``max_out`` is clamped to the narrower route's width (n/S rows,
    L * cap candidates), as both routes must fill one buffer.
    ``fn.estimate(state, params, queries)`` is the part both routes
    share and ``fn.hash_queries(params, queries, device)`` its hashing.
    """
    if policy not in ("global", "per_shard"):
        raise ValueError(policy)
    shards = mesh.shape[data_axis]
    n_local = n_total // shards
    engine = QueryEngine(cost_model)
    bucket_fn = bucket_fn_for(family, num_buckets)
    width = min(int(max_out), n_local, family.L * cap)

    def hash_queries(params, queries, dev):
        """The queries as rows on ``dev`` and their (L, Q) buckets."""
        q = as_rows(queries, metric, dev)
        return q, bucket_fn({k: v.to(dev) for k, v in params.items()}, q)

    def estimate(state: ShardedIndexState, params, queries):
        """The part of a query both routes share: the queries hashed once
        a device, each shard's segment and terms, and the global route
        from the psum of the collisions and the pmax of the registers.
        Returns (hashed by device, segments, terms, global route)."""
        hashed = {}
        segs, local = [], []
        for s, dev in enumerate(mesh.devices):
            if dev not in hashed:
                hashed[dev] = hash_queries(params, queries, dev)
            seg = TableSegment(
                tables=state.local_tables(s), x=state.x[s], metric=metric,
                cap=cap, n_live=n_local, n_scan=n_local,
                x_unit=None if state.x_unit is None else state.x_unit[s])
            (t,) = engine.segment_terms([seg], hashed[dev][1])
            segs.append(seg)
            local.append(t)
        merged = SegmentEstimate(
            collisions=mesh.psum([t.collisions for t in local])[0],
            merged_registers=mesh.pmax([t.merged_registers
                                        for t in local])[0],
            n_live=n_total, n_scan=n_total)
        return hashed, segs, local, finalize_route([merged], cost_model)

    def query(state: ShardedIndexState, params, queries, r,
              force: Optional[str] = None):
        hashed, segs, local, route_g = estimate(state, params, queries)
        nq = int(queries.shape[0])
        if force in ("lsh", "linear"):
            used = [force == "lsh"] * shards
        elif policy == "global":
            used = [prefers_lsh(route_g, nq)] * shards
        else:
            used = [prefers_lsh(finalize_route([t], cost_model), nq)
                    for t in local]
        out = []
        for s, (dev, seg) in enumerate(zip(mesh.devices, segs)):
            q, qb = hashed[dev]
            ids, dists, mask = compact_results(*engine.search_group(
                [seg], qb, q, float(r), lsh_route=used[s]), width)
            out.append((ids + s * n_local, dists, mask))
        ids, dists, mask = stack_shards(mesh, out)
        return {"ids": ids, "dists": dists, "mask": mask,
                "collisions": route_g.collisions,
                "cand_est": route_g.cand_est,
                "used_lsh": np.asarray(used, bool)}

    # the pieces, for counting each apart (launch.dryrun_retrieval)
    query.hash_queries, query.estimate = hash_queries, estimate
    return query
