"""Dry run of the paper's own workload on the production mesh: the
distributed hybrid query (Algorithm 2 with pmax-merged HLLs and
per-shard routing) over a 134M-vector corpus, on torch's meta device.

  PYTHONPATH=src python -m repro_torch.launch.dryrun_retrieval [--multi-pod]

The index is row-sharded over the mesh's 'data' axis (16 shards; the
'model' and 'pod' axes replicate a shard, as in the reference): each
shard holds n/S x d rows, an (L, n/S) perm, (L, B + 1) starts and
(L, B, m) registers, all meta tensors.  The candSize estimate is one
(Q, m) pmax and the collisions one (Q,) psum; each shard routes and
reports a fixed-size union slice.

Which route a shard takes depends on the data (``prefers_lsh`` reads a
scalar), so the dry run counts the shared estimate once
(``query.estimate``) and each route apart (``force=``, less the
estimate), and records both routes and their sum: what the reference's
``lax.cond`` costs with both branches counted.

Per chip: one controller hashes the queries once for the whole mesh (its
shards share the meta device), where each device of the reference hashes
them; so a chip's FLOPs and bytes are the hashing plus 1 / S of the rest
(each chip runs one shard's share), and its wire bytes are the
collectives' per-shard bytes.  The useful FLOPs are one full scan's,
2 Q n d.  The record goes to ``results/dryrun_torch/``.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Optional, Sequence

import torch

from repro_torch.core.cost_model import CostModel
from repro_torch.core.distributed import ShardedIndexState, make_query_fn
from repro_torch.core.lsh import make_family
from repro_torch.launch import hlo_analysis
from repro_torch.launch import roofline as rl
from repro_torch.launch.dryrun import RESULTS_DIR
from repro_torch.launch.mesh import make_production_mesh

META = torch.device("meta")


def _costs_dict(c: hlo_analysis.Costs) -> Dict:
    return {"flops": c.flops, "bytes accessed": c.bytes,
            "collectives": dict(c.wire),
            "collective_counts": dict(c.coll_counts)}


def run(*, multi_pod: bool = False, n_total: int = 1 << 27, d: int = 256,
        queries: int = 1024, L: int = 20, B: int = 1 << 18, m: int = 64,
        cap: int = 128, max_out: int = 256, r: float = 0.3,
        mesh=None) -> Dict:
    """The record of one dry run (``mesh``: a meta ``ShardMesh`` with a
    'data' axis in place of the production one)."""
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    if mesh.devices[0].type != "meta":
        raise ValueError(f"a dry run is of the meta device, not "
                         f"{mesh.devices[0]}")
    chips = mesh.size
    index_mesh = mesh.sub("data")
    shards = index_mesh.size
    n, q = n_total, queries
    n_local = n // shards
    fam = make_family("cosine", d=d, L=L, r=r, delta=0.1)
    params = fam.init(torch.Generator().manual_seed(0), device=META)

    def per_shard(shape, dtype):
        return [torch.empty(shape, dtype=dtype, device=META)
                for _ in range(shards)]

    state = ShardedIndexState(
        x=per_shard((n_local, d), torch.float32),
        perm=per_shard((L, n_local), torch.int32),
        starts=per_shard((L, B + 1), torch.int32),
        registers=per_shard((L, B, m), torch.uint8))
    qs = torch.empty((q, d), dtype=torch.float32, device=META)
    qfn = make_query_fn(fam, num_buckets=B, mesh=index_mesh, n_total=n,
                        cost_model=CostModel(1.0, 10.0), metric="cosine",
                        cap=cap, max_out=max_out, policy="per_shard")

    t0 = time.time()
    hashing = hlo_analysis.analyze_step(qfn.hash_queries, params, qs, META)
    estimate = hlo_analysis.analyze_step(qfn.estimate, state, params, qs)
    routes = {}
    for force in ("lsh", "linear"):
        c = hlo_analysis.analyze_step(qfn, state, params, qs, r, force=force)
        c.add(estimate, -1.0)
        routes[force] = c
    run_s = time.time() - t0

    both = hlo_analysis.Costs()
    for c in (estimate, routes["lsh"], routes["linear"]):
        both.add(c)
    rest = hlo_analysis.Costs()
    rest.add(both)
    rest.add(hashing, -1.0)
    per_chip = {"flops": hashing.flops + rest.flops / shards,
                "bytes accessed": hashing.bytes + rest.bytes / shards}
    wire = sum(both.wire.values())
    useful = 2.0 * q * n * d
    terms = rl.terms_from_cost(per_chip, wire, useful, chips)
    peak = max(estimate.peak_live_bytes,
               *(c.peak_live_bytes for c in routes.values()))
    return {
        "arch": "paper-hybrid-lsh-index", "shape": f"n={n},d={d},Q={q}",
        "mesh": "x".join(str(s) for s in mesh.shape.values()), "tag": "",
        "status": "ok", "chips": chips, "shards": shards,
        "run_s": round(run_s, 1),
        "memory": {"peak_live_bytes_global": peak},
        "cost": per_chip,
        "collectives": dict(both.wire),
        "collective_counts": dict(both.coll_counts),
        "hashing": _costs_dict(hashing),
        "estimate": _costs_dict(estimate),
        "routes": {k: _costs_dict(c) for k, c in routes.items()},
        "both_routes": _costs_dict(both),
        "terms": {"compute_s": terms.compute_s,
                  "memory_s": terms.memory_s,
                  "collective_s": terms.collective_s,
                  "dominant": terms.dominant,
                  "model_flops_global": useful,
                  "roofline_fraction": terms.roofline_fraction},
        "notes": {
            "device": "meta: shapes only, every shard on one controller",
            "routes": "estimate counted once; each route by force=, less "
                      "the estimate; both_routes = estimate + lsh + linear "
                      "(the reference's conditional, both branches)",
            "cost": "per chip: the hashing (once a device) + 1/S of the "
                    "rest of both_routes (one shard's share)",
        },
    }


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--n-total", type=int, default=1 << 27)  # 134M vectors
    ap.add_argument("--d", type=int, default=256)
    ap.add_argument("--queries", type=int, default=1024)
    args = ap.parse_args(argv)
    rec = run(multi_pod=args.multi_pod, n_total=args.n_total, d=args.d,
              queries=args.queries)
    os.makedirs(RESULTS_DIR, exist_ok=True)
    path = os.path.join(RESULTS_DIR,
                        f"paper-index__retrieval__{rec['mesh']}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec["terms"], indent=1))
    print("peak live GiB (global):",
          rec["memory"]["peak_live_bytes_global"] / 2**30)
    print("run_s:", rec["run_s"])


if __name__ == "__main__":
    main()
