"""CSR bucket tables with per-bucket HyperLogLogs (Algorithm 1).

Each LSH table is a CSR layout over a dense power-of-two bucket space:

  perm      (L, n)        point ids, sorted by bucket id, per table
  starts    (L, B + 1)    bucket offsets into ``perm``
  registers (L, B, m)     per-bucket HLL registers (uint8)

Build is one stable batched ``argsort`` over the (L, n) bucket ids, one
``bincount`` and one ``amax`` scatter.  Bucket *sizes* give the exact
``#collisions`` term of Eq. (1); the registers give the mergeable
candSize estimator.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import hll as hll_lib

__all__ = ["LSHTables", "build_tables", "table_index", "bucket_counts",
           "gather_registers", "gather_candidates"]


@dataclasses.dataclass
class LSHTables:
    """Stacked CSR tables."""

    perm: torch.Tensor        # (L, n) int32
    starts: torch.Tensor      # (L, B + 1) int32
    registers: torch.Tensor   # (L, B, m) uint8

    @property
    def L(self) -> int:
        return self.perm.shape[0]

    @property
    def n(self) -> int:
        return self.perm.shape[1]

    @property
    def num_buckets(self) -> int:
        return self.registers.shape[1]

    @property
    def m(self) -> int:
        return self.registers.shape[2]


def build_tables(ids: torch.Tensor, bucket_ids: torch.Tensor,
                 num_buckets: int, m: int) -> LSHTables:
    """ids: (n,) global point ids; bucket_ids: (n, L) per-table buckets.

    The sort must be stable: equal bucket ids keep their input order, as
    ``jnp.argsort`` keeps it, because that order decides which ids
    survive the ``cap`` cut in ``gather_candidates``.
    """
    b = bucket_ids.to(torch.int64).T.contiguous()          # (L, n)
    L, n = b.shape
    order = torch.argsort(b, dim=1, stable=True)
    perm = ids[order].to(torch.int32)
    offs = torch.arange(L, dtype=torch.int64, device=b.device)[:, None] \
        * num_buckets                                       # (L, 1)
    flat = (b + offs).reshape(-1)                           # table-major keys
    counts = torch.bincount(flat, minlength=L * num_buckets)
    counts = counts.reshape(L, num_buckets)
    starts = torch.cat([torch.zeros((L, 1), dtype=torch.int64,
                                    device=b.device),
                        torch.cumsum(counts, dim=1)], dim=1).to(torch.int32)
    regs = hll_lib.build_bucket_hlls(ids.repeat(L), flat, L * num_buckets, m)
    return LSHTables(perm, starts,
                     regs.reshape(L, num_buckets, m).to(torch.uint8))


def table_index(tables: LSHTables,
                tidx: torch.Tensor | None) -> torch.Tensor:
    """Virtual-table map, shaped (1, V): column j of a qbuckets array
    probes physical table ``tidx[j]`` (identity when tidx is None)."""
    if tidx is None:
        return torch.arange(tables.L, dtype=torch.int64,
                            device=tables.perm.device)[None, :]
    return tidx.to(torch.int64)[None, :]


def bucket_counts(tables: LSHTables, qbuckets: torch.Tensor,
                  tidx: torch.Tensor | None = None) -> torch.Tensor:
    """qbuckets: (Q, V) -> per-(query, probed bucket) sizes (Q, V) int32.

    ``sum(dim=-1)`` of the result is the exact #collisions of Eq. (1).
    """
    b = qbuckets.to(torch.int64)                          # (Q, V)
    lidx = table_index(tables, tidx)                      # (1, V)
    return tables.starts[lidx, b + 1] - tables.starts[lidx, b]


def gather_registers(tables: LSHTables, qbuckets: torch.Tensor,
                     tidx: torch.Tensor | None = None) -> torch.Tensor:
    """(Q, V) bucket ids -> (Q, V, m) HLL registers of the hit buckets."""
    lidx = table_index(tables, tidx)
    return tables.registers[lidx, qbuckets.to(torch.int64)]


def gather_candidates(tables: LSHTables, qbuckets: torch.Tensor, cap: int,
                      sentinel: int,
                      tidx: torch.Tensor | None = None) -> torch.Tensor:
    """Fixed-capacity candidate gather: (Q, V) buckets -> (Q, V*cap) int32.

    Each probed bucket contributes up to ``cap`` ids; slots beyond the
    bucket size hold ``sentinel`` (an id == n, sorting after every real
    id).  Truncation beyond ``cap`` is a recall risk only for buckets the
    cost model routes to linear search anyway.
    """
    b = qbuckets.to(torch.int64)                          # (Q, V)
    lidx = table_index(tables, tidx)
    lo = tables.starts[lidx, b].to(torch.int64)           # (Q, V)
    size = tables.starts[lidx, b + 1].to(torch.int64) - lo
    offs = torch.arange(cap, dtype=torch.int64, device=b.device)
    idx = lo[..., None] + offs                            # (Q, V, cap)
    valid = offs < size[..., None]
    gathered = tables.perm[lidx[..., None], idx.clamp(0, tables.n - 1)]
    cands = torch.where(valid, gathered,
                        torch.full_like(gathered, sentinel))
    return cands.reshape(qbuckets.shape[0], qbuckets.shape[1] * cap)
