"""The static ``HybridLSHIndex`` (``repro_torch.core.index``) under test.

Built once in set-up on the whole corpus (Algorithm 1) and then only
queried (Algorithm 2); its one segment holds the corpus in row order,
every row live, external id = row.
"""
from __future__ import annotations

import torch

from bench.reference.judge import Segment
from bench.systems._index import (  # noqa: F401  (the cell's data, traffic, check)
    Traffic, check, keep_traced, make_data)


class Snapshot:
    """What a query saw: one segment over the corpus in row order."""

    def __init__(self, n: int, device):
        self.n_scan, self.device = n, device

    def layout(self):
        """(the one segment, Eq. 2's scanned rows: the corpus, nothing
        of the program's layout that differs)."""
        ext = torch.arange(self.n_scan, dtype=torch.int64, device=self.device)
        return [Segment(ext=ext, sketch=True)], self.n_scan, 0

    def live_ext(self) -> torch.Tensor:
        return torch.arange(self.n_scan, dtype=torch.int64, device=self.device)


class System:
    def __init__(self, cfg: dict, data, device):
        from repro_torch.core.cost_model import CostModel
        from repro_torch.core.index import HybridLSHIndex
        from repro_torch.core.lsh.families import make_family
        self.r = data.r
        self.family = make_family(cfg["metric"], d=cfg["d"], L=cfg["L"],
                                  r=data.r, delta=cfg["delta"],
                                  k=cfg.get("k"),
                                  w=(float(cfg["w_over_r"]) * data.r
                                     if "w_over_r" in cfg else None))
        self.index = HybridLSHIndex(
            self.family, num_buckets=cfg["num_buckets"], m=cfg["m"],
            cap=cfg["cap"], cost_model=CostModel(cfg["alpha"], cfg["beta"]),
            params=data.params, device=device)
        self.index.build(data.corpus)
        self.n = data.corpus.shape[0]

    def query(self, q: torch.Tensor):
        return self.index.query(q, self.r)

    def snapshot(self) -> "Snapshot":
        return Snapshot(self.n, self.index.x.device)

    def counters(self) -> dict:
        return {"segments": 1}

    def close(self) -> None:
        self.index = None
