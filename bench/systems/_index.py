"""What the two index systems (``static_index``, ``streaming_index``)
share: their data, their traffic and their check.  Each of the two
modules exposes these names, which is where the harness looks for them.

- ``make_data``: the Gaussian-mixture corpus, its radius and the LSH
  parameters from the deployment's generator, the query pool from the
  run's (``bench/lib/data.py``).
- ``Traffic``: the one generator of the index mixes (``bench/traffic/``):
  a round is one query batch of ``batch_queries`` rows of the seeded
  pool, in a seeded order (a fresh permutation of the pool each pass);
  the live corpus is the whole corpus (external ids 0..n-1).
- ``keep_traced``: the routes of a traced round, all its check needs of
  the result.
- ``check``: the judged batches held to ``bench/reference/`` (and, for
  the control, the reference in the program's place at the lower
  precision); the per-layer work counts of the priced traced rounds.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from bench.lib.data import make_data  # noqa: F401  (a system module's name)
from bench.reference import judge as judge_lib
from bench.reference import lsh

CHECKS = ("report_gap", "distance_gap", "route_gap", "collision_excess",
          "estimate_gap", "state_mismatch")
ANSWER_CHECKS = CHECKS[:5]     # the numbers ``judge`` gives


class Traffic:
    def __init__(self, mix: dict, data, seed: int, device):
        self.batch = int(mix["batch_queries"])
        self.gen = torch.Generator(device=device).manual_seed(
            (int(seed) * 0x9E3779B97F4A7C15 + 1) % (1 << 63))
        self.queries = data.queries
        self.pool = data.queries.shape[0]
        if self.batch > self.pool:
            raise ValueError("batch_queries exceeds the query pool")
        self._order = None
        self._pos = self.pool
        self.n = data.corpus.shape[0]

    def next(self):
        """(the next batch's query rows, their pool rows as indices on
        the device)."""
        if self._pos + self.batch > self.pool:
            self._order = torch.randperm(self.pool, generator=self.gen,
                                         device=self.gen.device)
            self._pos = 0
        idx = self._order[self._pos:self._pos + self.batch]
        self._pos += self.batch
        return self.queries[idx], idx

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


def keep_traced(res, idx) -> np.ndarray:
    """Which of the batch's queries went to LSH."""
    use = np.zeros(idx.shape[0], bool)
    use[np.asarray(res.lsh_idx, np.int64)] = True
    return use


def answer(res) -> judge_lib.Answer:
    """The port's ``QueryResult`` as the judge reads it."""
    pq, pe, pd = [], [], []
    for idx, grp in ((res.lsh_idx, res.lsh_out), (res.lin_idx, res.lin_out)):
        if grp is None:
            continue
        ids, dists, mask = grp
        qi, col = torch.nonzero(mask, as_tuple=True)
        sel = torch.as_tensor(np.asarray(idx, np.int64), device=ids.device)
        pq.append(sel[qi])
        pe.append(ids[qi, col].to(torch.int64))
        pd.append(dists[qi, col])
    rt = res.route
    return judge_lib.Answer(rt.use_lsh.to(torch.bool), rt.collisions,
                            rt.cand_est, torch.cat(pq), torch.cat(pe),
                            torch.cat(pd))


def check(cfg: dict, data, judged, traced, control: bool, left) -> Dict:
    """``judged``: (result, pool rows, live ids, snapshot) of each judged
    batch; ``traced``: (pool rows, routes, live ids, snapshot) of each
    priced traced batch, or None.  ``left`` is unused: the reference
    works from the benchmark's own corpus."""
    bank = data.corpus
    bh = lsh.bucket_ids(cfg, data.params, bank, data.r)
    ctl_bh = (lsh.bucket_ids(cfg, data.params, bank, data.r, "tf32")
              if control else None)

    def state(snap, hashes):
        segs, n_scan, _ = snap.layout()
        return judge_lib.RefState(segs, bank, hashes, cfg, n_scan)

    out = {k: 0.0 for k in CHECKS}
    out.update(judged_queries=0, pairs_due=0, pairs_reported=0,
               misrouted=0, doubtful_queries=0)
    ctl = {k: 0.0 for k in ANSWER_CHECKS}
    for res, idx, live, snap in judged:
        qv = data.queries[idx]
        qh = lsh.bucket_ids(cfg, data.params, qv, data.r)
        st = state(snap, bh)
        got = judge_lib.judge(st, qv, qh, live, data.r, answer(res))
        for k in ANSWER_CHECKS:
            out[k] = max(out[k], got[k])
        out["judged_queries"] += got["queries"]
        for k in ("pairs_due", "pairs_reported", "misrouted",
                  "doubtful_queries"):
            out[k] += got[k]
        held = snap.live_ext()
        uniq = torch.unique(held)
        out["state_mismatch"] = max(out["state_mismatch"], float(
            live.mismatch(uniq) + held.numel() - uniq.numel()
            + snap.layout()[2]))
        if control:
            qc = lsh.bucket_ids(cfg, data.params, qv, data.r, "tf32")
            cans = judge_lib.control_answer(state(snap, ctl_bh), qv, qc,
                                            live, data.r)
            cgot = judge_lib.judge(st, qv, qh, live, data.r, cans)
            for k in ANSWER_CHECKS:
                ctl[k] = max(ctl[k], cgot[k])
            # only the distances below the configuration's precision
            dans = judge_lib.control_answer(st, qv, qh, live, data.r)
            dgot = judge_lib.judge(st, qv, qh, live, data.r, dans)
            for k in ANSWER_CHECKS:
                key = k + "_distances_only"
                ctl[key] = max(ctl.get(key, 0.0), dgot[k])
            # the route's own fault: the control with every route flipped
            flip = judge_lib.judge(st, qv, qh, live, data.r,
                                   dataclasses.replace(
                                       cans, use_lsh=~cans.use_lsh))
            ctl["route_gap_flipped"] = max(
                ctl.get("route_gap_flipped", 0.0), flip["route_gap"])
        del st, res
    out["misroute_pct"] = 100.0 * out["misrouted"] / max(
        out["judged_queries"], 1)
    work = None
    if traced is not None:
        work = {}
        for idx, use, live, snap in traced:
            qv = data.queries[idx]
            qh = lsh.bucket_ids(cfg, data.params, qv, data.r)
            w = judge_lib.batch_work(
                state(snap, bh), qv, qh, live, data.r,
                torch.as_tensor(use, device=qv.device))
            for k, v in w.items():
                work[k] = v if k in ("d", "L", "m") else work.get(k, 0) + v
        work = work or None
    readings = {k: out.pop(k) for k in list(out) if k not in CHECKS}
    return {"compared": out, "judged": readings["judged_queries"],
            "readings": readings,
            "info": {"radius": data.r,
                     **{k: readings[k] for k in (
                         "judged_queries", "pairs_due", "pairs_reported",
                         "doubtful_queries", "misroute_pct")}},
            "control": ctl if control else None, "work": work}
