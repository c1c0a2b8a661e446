"""The streaming ``DynamicHybridIndex`` (``repro_torch.streaming``) under
test, built in set-up as one frozen segment over the corpus (and an
empty delta), then only queried.

``snapshot`` records what a query saw: which ids each frozen segment
holds and in which order (immutable tensors, held by reference), a copy
of the delta's, and the program's own live masks, which the benchmark
checks against its own bookkeeping.  Which ids sit in which segment is
the program's; the reference takes only that set.  It lays each segment
out itself: real rows in ascending external id (insertion order, as a
stable sort of the ids gives it), then pad rows to ``pad_rows``, and
prices Eq. 2 over those sizes.  ``layout`` counts each row the program
places otherwise and each segment it pads otherwise, for
``state_mismatch``.
"""
from __future__ import annotations

import torch

from bench.reference.judge import Segment
from bench.systems._index import (  # noqa: F401  (the cell's data, traffic, check)
    Traffic, check, keep_traced, make_data)


def pad_rows(k: int) -> int:
    """Rows of a frozen segment of k real rows: the next power of two,
    at least 8 (the layout the paper's padded segments take)."""
    k = max(int(k), 1)
    return max(8, 1 << (k - 1).bit_length())


class Snapshot:
    def __init__(self, index):
        segs = index.stack.segments
        self.frozen = [(f.seg.ids, f.tomb.live, f.n_pad) for f in segs]
        d = index.delta
        self.delta_ids = d.ids[:d.count].clone()
        self.delta_live = d.live[:d.count].clone()

    def layout(self):
        """(segments as the reference lays them out, Eq. 2's scanned
        rows, rows and paddings of the program's layout that differ)."""
        segs, n_scan, wrong = [], 0, 0
        for ids, _, n_pad in self.frozen:
            ids = ids.to(torch.int64)
            real = ids[ids >= 0]
            own = torch.sort(real, stable=True).values
            n = pad_rows(own.numel())
            ext = torch.full((n,), -1, dtype=torch.int64, device=ids.device)
            ext[:own.numel()] = own
            same = min(n, ids.numel())
            wrong += int((ids[:same] != ext[:same]).sum()) + abs(
                ids.numel() - n) + int(n_pad != n)
            segs.append(Segment(ext=ext, sketch=True))
            n_scan += n
        dext = self.delta_ids.to(torch.int64)
        segs.append(Segment(ext=dext, sketch=False))
        return segs, n_scan + dext.numel(), wrong

    def live_ext(self) -> torch.Tensor:
        """External ids the program holds live."""
        parts = [ids[live[:n] & (ids >= 0)].to(torch.int64)
                 for ids, live, n in self.frozen]
        parts.append(self.delta_ids[self.delta_live].to(torch.int64))
        return torch.cat(parts)


class System:
    def __init__(self, cfg: dict, data, device):
        from repro_torch.core.cost_model import CostModel
        from repro_torch.core.lsh.families import make_family
        from repro_torch.streaming import CompactionPolicy, DynamicHybridIndex
        self.r = data.r
        fam = make_family(cfg["metric"], d=cfg["d"], L=cfg["L"], r=data.r,
                          delta=cfg["delta"], k=cfg.get("k"),
                          w=(float(cfg["w_over_r"]) * data.r
                             if "w_over_r" in cfg else None))
        pol = cfg["policy"]
        self.index = DynamicHybridIndex(
            fam, num_buckets=cfg["num_buckets"], m=cfg["m"], cap=cfg["cap"],
            delta_capacity=cfg["delta_capacity"],
            cost_model=CostModel(cfg["alpha"], cfg["beta"]),
            policy=CompactionPolicy(
                delta_fill=pol["delta_fill"],
                tombstone_ratio=pol["tombstone_ratio"],
                fanout=pol["fanout"], step_rows=pol["step_rows"]),
            params=data.params, device=device)
        self.index.build(data.corpus)

    def query(self, q: torch.Tensor):
        return self.index.query(q, self.r)

    def snapshot(self) -> Snapshot:
        return Snapshot(self.index)

    def counters(self) -> dict:
        st = self.index.index_stats()
        return {"segments": st["segments"] + 1}

    def close(self) -> None:
        self.index = None
