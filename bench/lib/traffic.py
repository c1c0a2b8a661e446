"""The one traffic generator: it reads a mix's parameters (a JSON file
under ``bench/traffic/``) and produces the rounds of a closed loop.

A round is one query batch of ``batch_queries`` rows of the seeded query
pool, in a seeded order (a fresh permutation of the pool each pass).
The live corpus is the whole corpus (external ids 0..n-1).
"""
from __future__ import annotations

import torch


class Traffic:
    def __init__(self, mix: dict, data, seed: int, device):
        self.batch = int(mix["batch_queries"])
        self.gen = torch.Generator(device=device).manual_seed(
            (int(seed) * 0x9E3779B97F4A7C15 + 1) % (1 << 63))
        self.pool = data.queries.shape[0]
        if self.batch > self.pool:
            raise ValueError("batch_queries exceeds the query pool")
        self._order = None
        self._pos = self.pool
        self.n = data.corpus.shape[0]

    def next_queries(self) -> torch.Tensor:
        """Pool rows of the next batch (indices on the device)."""
        if self._pos + self.batch > self.pool:
            self._order = torch.randperm(self.pool, generator=self.gen,
                                         device=self.gen.device)
            self._pos = 0
        idx = self._order[self._pos:self._pos + self.batch]
        self._pos += self.batch
        return idx

    def live(self) -> "Live":
        """The live ids as they stand now."""
        return Live(0, self.n)


class Live:
    """The live external ids [lo, hi); called on ids, a bool tensor."""

    def __init__(self, lo: int, hi: int):
        self.lo, self.hi = lo, hi

    def __call__(self, ext: torch.Tensor) -> torch.Tensor:
        return (ext >= self.lo) & (ext < self.hi)

    def mismatch(self, held: torch.Tensor) -> int:
        """Ids in ``held`` (unique) that are not live, plus live ids
        missing from it."""
        inside = int(self(held).sum())
        return (held.numel() - inside) + (self.hi - self.lo - inside)
