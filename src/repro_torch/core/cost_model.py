"""The paper's computational cost model (Sec. 3.1, Eq. 1-2).

  LSHCost    = alpha * #collisions + beta * candSize        (1)
  LinearCost = beta * n                                     (2)

alpha = average cost of processing one colliding entry (bucket lookup +
duplicate removal), beta = cost of one distance computation.  Only the
ratio beta/alpha matters for routing; the paper sets it per dataset
(10, 10, 6, 1 for Webspam/CoverType/Corel/MNIST).
"""
from __future__ import annotations

import dataclasses

__all__ = ["CostModel", "PAPER_PRESETS"]


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
