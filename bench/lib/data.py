"""A cell's data, made on the device from ``--seed``.

The recipe is the paper-analogue Gaussian mixture: ``n_clusters`` unit
centres, rows at a centre plus ``cluster_scale`` noise, and a
``dense_core_frac`` share of the rows in one tight ``core_scale`` cluster
around centre 0 (the regime where queries with near-n outputs make
linear search win).  Cosine rows are scaled to unit length.

The deployment is fixed by the configuration: its ``deployment_seed``
draws the centres, the corpus, the radius and then the LSH parameters,
as a deployment serves one dataset with one built index.  ``--seed``
draws the traffic: the query pool from the same mixture, and its order.
Every draw is a few large calls on the device's ``torch.Generator``;
nothing is generated on the host.
"""
from __future__ import annotations

import dataclasses

import torch

from bench.reference import lsh

RADIUS_PAIRS = 131072


@dataclasses.dataclass
class Data:
    corpus: torch.Tensor            # (n, d) float32; external id = row
    queries: torch.Tensor           # (pool, d) float32
    r: float                        # the cell's radius
    params: dict                    # the LSH family's draws (lsh.draw_params)


def mixture(gen: torch.Generator, centers: torch.Tensor, n: int, mix: dict,
            metric: str) -> torch.Tensor:
    """n rows of the configuration's mixture around ``centers``."""
    dev, d = centers.device, centers.shape[1]
    n_core = int(n * float(mix["dense_core_frac"]))
    n_rest = n - n_core
    assign = torch.randint(0, centers.shape[0], (n_rest,), generator=gen,
                           device=dev)
    pts = centers[assign] + float(mix["cluster_scale"]) * torch.randn(
        (n_rest, d), generator=gen, device=dev)
    if n_core:
        core = centers[0] + float(mix["core_scale"]) * torch.randn(
            (n_core, d), generator=gen, device=dev)
        pts = torch.cat([pts, core])
        pts = pts[torch.randperm(n, generator=gen, device=dev)]
    if metric == "cosine":
        pts = pts / pts.norm(dim=1, keepdim=True).clamp(min=1e-9)
    return pts.contiguous()


def pair_distances(x: torch.Tensor, gen: torch.Generator, metric: str,
                   pairs: int = RADIUS_PAIRS) -> torch.Tensor:
    """Float64 distances of ``pairs`` random row pairs."""
    n = x.shape[0]
    a = x[torch.randint(0, n, (pairs,), generator=gen, device=x.device)]
    b = x[torch.randint(0, n, (pairs,), generator=gen, device=x.device)]
    a, b = a.to(torch.float64), b.to(torch.float64)
    if metric == "l1":
        return (a - b).abs().sum(1)
    if metric == "cosine":
        return 1.0 - (a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1)).clamp(
            min=1e-12)
    raise ValueError(f"metric {metric!r}")


def make_data(cfg: dict, mix: dict, dep: torch.Generator,
              gen: torch.Generator) -> Data:
    """Corpus, radius and LSH parameters from the deployment's generator
    ``dep``; the query pool from the run's generator ``gen``."""
    dev = dep.device
    d, metric = int(cfg["d"]), cfg["metric"]
    m = cfg["mixture"]
    centers = torch.randn((int(m["n_clusters"]), d), generator=dep,
                          device=dev)
    centers = centers / centers.norm(dim=1, keepdim=True)
    corpus = mixture(dep, centers, int(cfg["n"]), m, metric)
    dist = pair_distances(corpus, dep, metric)
    r = float(torch.quantile(dist, float(mix["radius_quantile"])))
    queries = mixture(gen, centers, int(cfg["query_pool"]), m, metric)
    return Data(corpus, queries, r, lsh.draw_params(cfg, r, dep))
