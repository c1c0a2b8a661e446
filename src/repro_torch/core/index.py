"""HybridLSHIndex — the paper's data structure as a single-device module.

Build (Algorithm 1): hash all points into L CSR tables, with one
HyperLogLog per bucket.  Query (Algorithm 2): one static
``TableSegment`` handed to the shared ``QueryEngine``, which estimates
per-query LSHCost from bucket sizes + merged HLLs (the HLL merge kernel),
routes each query to LSH-based or linear search, and runs both groups
through the fused scan kernels.

The index lives on ``device``, "cuda" unless the caller asks otherwise;
there is no silent CPU fallback.

Observability: ``obs=`` takes a ``repro_torch.obs.Observability`` bundle
(default a fresh disabled one) whose tracer the query engine takes, as
``DynamicHybridIndex``'s does; ``query`` and ``build`` open the profiler
spans ``hlsh.query``, ``hlsh.hash`` and ``hlsh.build``
(``repro_torch.obs.spans``), and ``index_stats()`` reports the engine's
counters and the last build's seconds.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.cost_model import CostModel
from repro_torch.core.engine import (QueryEngine, QueryResult, RouteEstimate,
                                     TableSegment)
from repro_torch.core.lsh.families import bucket_fn_for
from repro_torch.core.lsh.tables import LSHTables, build_tables
from repro_torch.kernels import ops
from repro_torch.kernels.ref import unit_rows
from repro_torch.obs import Observability
from repro_torch.obs.spans import span
from repro_torch.u32 import as_i32

__all__ = ["HybridLSHIndex", "QueryResult", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU; asking for CUDA without one raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch versions on the CPU")
    return device


def as_rows(x, metric: str, device) -> torch.Tensor:
    """Corpus or query rows as a tensor on ``device``: float32, or for
    Hamming the packed uint32 codes as an int32 bit view."""
    if isinstance(x, torch.Tensor):
        t = x
    else:
        a = np.ascontiguousarray(x)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        t = torch.from_numpy(a)
    t = as_i32(t) if metric == "hamming" else t.to(torch.float32)
    return t.to(device).contiguous()


class HybridLSHIndex:
    """Hybrid LSH/linear r-NN reporting index (the paper's contribution).

    Random parameters come from ``params`` (a dict of tensors, e.g. a
    reference index's draws through ``repro_torch.interop``) or are drawn
    from ``seed`` (a ``torch.Generator``, or an int to seed one).
    ``obs`` is an observability bundle (tracer + event log + registry);
    the default is a fresh disabled one, which costs nothing.
    """

    def __init__(self, family, *, num_buckets: int, m: int = 64,
                 cap: int = 64,
                 cost_model: CostModel = CostModel(alpha=1.0, beta=10.0),
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 seed: torch.Generator | int = 0,
                 impl: Optional[str] = None,
                 obs: Optional[Observability] = None, device=None):
        self.device = resolve_device(device)
        if params is None:
            gen = seed
            if not isinstance(gen, torch.Generator):
                gen = torch.Generator().manual_seed(int(seed))
            params = family.init(gen, device=self.device)
        self.family = family
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.num_buckets = int(num_buckets)
        self.m = int(m)
        self.cap = int(cap)
        self.cost_model = cost_model
        self.impl = impl
        self.x = None
        self.tables: Optional[LSHTables] = None
        self.obs = obs if obs is not None else Observability.disabled()
        self._engine = QueryEngine(cost_model, impl=impl,
                                   tracer=self.obs.tracer)
        self.build_seconds = 0.0   # the last build's wall seconds
        self._bucket_fn = bucket_fn_for(self.family, self.num_buckets, impl)

    # ------------------------------------------------------------------
    @property
    def x(self) -> Optional[torch.Tensor]:
        """The corpus rows on the device."""
        return self._x

    @x.setter
    def x(self, rows: Optional[torch.Tensor]) -> None:
        # cosine on the kernel route: the linear scan reads unit rows,
        # made here once per corpus instead of once per query chunk
        self._x = rows
        self._x_unit = None
        if (rows is not None and self.family.metric == "cosine"
                and ops.resolve_impl(self.impl, rows.device) == "cuda"):
            self._x_unit = unit_rows(rows.to(torch.float32)).contiguous()

    @property
    def n(self) -> int:
        return 0 if self.x is None else int(self.x.shape[0])

    def bucket_ids(self, x: torch.Tensor, chunk: int = 65536) -> torch.Tensor:
        """(n, L) int32 bucket ids of rows already on the device, one hash
        call a chunk of rows (a query batch is one chunk: no copy)."""
        parts = [self._bucket_fn(self.params, x[lo:lo + chunk])
                 for lo in range(0, max(x.shape[0], 1), chunk)]
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def build(self, x, chunk: int = 65536) -> "HybridLSHIndex":
        """Algorithm 1: hash + CSR sort + per-bucket HLL build, timed on
        the host clock to its end on the device (``build_seconds``)."""
        with span("hlsh.build"):
            t0 = time.perf_counter()
            self.x = as_rows(x, self.family.metric, self.device)
            ids = torch.arange(self.n, dtype=torch.int32, device=self.device)
            self.tables = build_tables(ids, self.bucket_ids(self.x, chunk),
                                       self.num_buckets, self.m)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.build_seconds = time.perf_counter() - t0
        return self

    # ------------------------------------------------------------------
    def _segment(self) -> TableSegment:
        if self.tables is None:
            raise RuntimeError("index is empty: build first")
        return TableSegment(tables=self.tables, x=self.x,
                            metric=self.family.metric, cap=self.cap,
                            impl=self.impl, x_unit=self._x_unit)

    def estimate(self, queries) -> RouteEstimate:
        """Algorithm 2 lines 1-4, vectorized over the query batch."""
        q = as_rows(queries, self.family.metric, self.device)
        return self._engine.estimate([self._segment()], self.bucket_ids(q))

    def query(self, queries, r: float,
              force: Optional[str] = None) -> QueryResult:
        """Hybrid r-NN reporting.

        force: None (hybrid routing) | "lsh" | "linear" — the two
        baselines of the paper's Figure 2.
        """
        with span("hlsh.query"):
            q = as_rows(queries, self.family.metric, self.device)
            with span("hlsh.hash"):
                qb = self.bucket_ids(q)
            self._engine.count_hash(self.family, q, self.impl,
                                    calls=-(-max(q.shape[0], 1) // 65536))
            return self._engine.query([self._segment()], q, qb, float(r),
                                      force=force)

    # ------------------------------------------------------------------
    def index_stats(self) -> Dict[str, Any]:
        """``query``: the engine's ``batches``, ``syncs``,
        ``hash_kernel_batches`` and ``lsh_kernel_groups``
        (``QueryEngine.stats``); ``build_seconds``: the last build's."""
        return {"query": self._engine.stats(),
                "build_seconds": self.build_seconds}

    def memory_stats(self) -> Dict[str, Any]:
        t = self.tables
        if t is None:   # not built yet: report an empty footprint
            return {"perm_bytes": 0, "starts_bytes": 0, "hll_bytes": 0,
                    "hll_overhead_vs_data": 0.0}
        return {
            "perm_bytes": t.perm.numel() * 4,
            "starts_bytes": t.starts.numel() * 4,
            "hll_bytes": t.registers.numel(),
            "hll_overhead_vs_data": t.registers.numel() / max(
                1, self.x.numel() * self.x.element_size()),
        }
