"""Core library: the paper's Hybrid LSH r-NN reporting data structure.

Public surface:
  * ``HybridLSHIndex``  — single-device build/query (Algorithms 1 + 2)
  * ``core.engine``     — the segment engine: ``QueryEngine`` + the
                          ``TableSegment`` of the static index
  * ``core.lsh``        — LSH families + CSR tables
  * ``core.hll``        — HyperLogLog sketches
  * ``core.cost_model`` — Eq. (1)/(2), and ``calibrate`` of beta/alpha
  * ``core.distributed`` — the row-sharded static index over a
                          ``ShardMesh`` (``make_mesh``, ``build_sharded``,
                          ``make_query_fn``)
"""
from repro_torch.core.cost_model import PAPER_PRESETS, CostModel, calibrate
from repro_torch.core.engine import (QueryEngine, RouteEstimate,
                                     SegmentEstimate, TableSegment,
                                     finalize_route)
from repro_torch.core.index import HybridLSHIndex, QueryResult
from repro_torch.core.distributed import (ShardedIndexState, ShardMesh,
                                          build_sharded, make_mesh,
                                          make_query_fn)

__all__ = ["CostModel", "PAPER_PRESETS", "calibrate", "HybridLSHIndex",
           "QueryResult", "RouteEstimate", "QueryEngine", "SegmentEstimate",
           "TableSegment", "finalize_route", "ShardMesh", "make_mesh",
           "ShardedIndexState", "build_sharded", "make_query_fn"]
