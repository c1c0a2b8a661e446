"""Quickstart for the PyTorch/CUDA port: build a Hybrid LSH index on the
GPU, report r-near neighbors, and watch the router choose strategies
(Algorithms 1+2 of the paper).

  PYTHONPATH=src python examples/quickstart_torch.py

Needs a CUDA device: the index defaults to ``device="cuda"`` and does not
fall back to the CPU.
"""
import numpy as np

from repro_torch.core import CostModel, HybridLSHIndex
from repro_torch.core.lsh import make_family
from repro_torch.data import clustered_dataset, query_split


def main():
    # A dataset with a dense core: some queries are "hard" (paper Fig 1).
    x = clustered_dataset(20000, 32, n_clusters=16, dense_core_frac=0.25,
                          core_scale=0.02, seed=0)
    x, queries = query_split(x, n_queries=50, seed=0)
    r = 0.45

    fam = make_family("l2", d=32, L=20, r=r, delta=0.1)
    index = HybridLSHIndex(
        fam, num_buckets=2048, m=64, cap=256,
        cost_model=CostModel(alpha=1.0, beta=10.0), seed=0, device="cuda")
    index.build(x)
    print(f"indexed n={index.n} d=32 on {index.device}, L={fam.L} "
          f"k={fam.k}, HLL m={index.m}")
    print("index memory:", {k: f"{v/1e6:.1f}MB" if k.endswith('bytes')
                            else round(v, 4)
                            for k, v in index.memory_stats().items()})

    est = index.estimate(queries)
    print("\nper-query cost estimates (first 8):")
    for i in range(8):
        print(f"  q{i}: #collisions={int(est.collisions[i]):6d} "
              f"candSize~{float(est.cand_est[i]):8.1f} "
              f"LSHCost={float(est.lsh_cost[i]):10.1f} "
              f"LinearCost={est.linear_cost:10.1f} "
              f"-> {'LSH' if bool(est.use_lsh[i]) else 'LINEAR'}")

    res = index.query(queries, r)
    sizes = [len(res.neighbors(i)) for i in range(res.n_queries)]
    print(f"\nreported output sizes: mean={np.mean(sizes):.1f} "
          f"max={max(sizes)} min={min(sizes)}")
    print(f"fraction routed to linear search: {res.frac_linear:.2f}")


if __name__ == "__main__":
    main()
