"""The paper's computational cost model (Sec. 3.1, Eq. 1-2).

  LSHCost    = alpha * #collisions + beta * candSize        (1)
  LinearCost = beta * n                                     (2)

alpha = average cost of processing one colliding entry (bucket lookup +
duplicate removal), beta = cost of one distance computation.  Only the
ratio beta/alpha matters for routing; the paper sets it per dataset
(10, 10, 6, 1 for Webspam/CoverType/Corel/MNIST).  ``calibrate`` measures
both on the device with the same kernels the search paths use.
"""
from __future__ import annotations

import dataclasses
import time

import torch

__all__ = ["CostModel", "PAPER_PRESETS", "calibrate"]


@dataclasses.dataclass(frozen=True)
class CostModel:
    alpha: float = 1.0
    beta: float = 10.0

    def lsh_cost(self, collisions, cand_size):
        return self.alpha * collisions + self.beta * cand_size

    def linear_cost(self, n):
        return self.beta * n

    def use_lsh(self, collisions, cand_size, n):
        """Algorithm 2 line 4: True -> LSH-based search."""
        return self.lsh_cost(collisions, cand_size) < self.linear_cost(n)


# beta/alpha presets from the paper's experiments (alpha normalized to 1).
PAPER_PRESETS = {
    "webspam": CostModel(alpha=1.0, beta=10.0),
    "covertype": CostModel(alpha=1.0, beta=10.0),
    "corel": CostModel(alpha=1.0, beta=6.0),
    "mnist": CostModel(alpha=1.0, beta=1.0),
}


def _time_fn(fn, device: torch.device, iters: int = 5) -> float:
    """Seconds per call of ``fn()``: one warm-up call, then ``iters``
    calls between two device synchronisations (the device runs
    asynchronously, so the host clock alone would time the enqueue)."""
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    return (time.perf_counter() - t0) / iters


def calibrate(d: int, metric: str = "l2", n_probe: int = 4096,
              seed: int = 0, device=None) -> CostModel:
    """Measure (alpha, beta) with the production kernels on ``device``
    ("cuda" unless the caller asks otherwise; raises without CUDA).

    beta: per-point cost of a distance scan, the time of
    ``ops.pairwise_dist`` (the unfused distance-matrix kernel) over
    64 x ``n_probe`` pairs; alpha: per-entry cost of the sort-based
    duplicate removal (``search.dedupe_sorted``) over as many ids.
    Returns a CostModel with alpha normalized to 1 (matching how the
    paper reports beta/alpha).  The inputs are random draws from a
    generator seeded with ``seed``; only their timings come out.
    """
    from repro_torch.core import search as search_lib
    from repro_torch.core.index import resolve_device
    from repro_torch.kernels import ops

    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n_probe, d), generator=gen, device=device)
    q = torch.randn((64, d), generator=gen, device=device)
    ids = torch.randint(0, n_probe, (64, n_probe), generator=gen,
                        device=device, dtype=torch.int32)

    beta_t = _time_fn(lambda: ops.pairwise_dist(q, x, metric),
                      device) / (64 * n_probe)

    def dedupe():
        # ids < n_probe, so sentinel=n_probe keeps every unique id.
        _, uniq = search_lib.dedupe_sorted(ids, sentinel=n_probe)
        return torch.sum(uniq, dim=-1)

    alpha_t = max(_time_fn(dedupe, device) / (64 * n_probe), 1e-12)
    return CostModel(alpha=1.0, beta=max(beta_t / alpha_t, 1e-3))
