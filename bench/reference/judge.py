"""The reference index and the comparison that decides ``correct``.

``RefState`` rebuilds, from the benchmark's own data and hashes, what an
index holding the given segments must answer: per query and table the
rows that collide, the rows the per-bucket cap surely or possibly admits
(first ``cap`` rows of a bucket in row order, as a stable CSR sort lays
them out), the HLL registers of the colliding rows and the Eq. (1)/(2)
costs.  Where the reference's hashes carry doubt (``lsh.Hashes``), every
count becomes an interval; with point hashes (the control's) the same
code gives a point answer.

``judge`` holds an index's answer for one query batch to the reference
and returns the numbers that are compared, each a "widest gap": 0 when
the answer is inside the reference's interval, else how far outside.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from bench.reference import lsh

GAP_FOREIGN = 1.0        # a reported row that no reading of the hashes admits
Q_BLOCK_ELEMS = 1 << 24  # (queries x rows) elements a block holds


@dataclasses.dataclass
class Segment:
    """One searchable unit of an index, as the reference sees it.

    ``ext``: (n,) int64 external ids in the index's row order, -1 on pad
    rows.  ``sketch``: a CSR + HLL segment (the cap applies, the estimate
    is an HLL less the dead collisions); else an exact one (the delta)."""
    ext: torch.Tensor
    sketch: bool


class _Seg:
    """Per-segment arrays over its real rows (pad rows dropped; ``pos``
    keeps each row's place in the segment): row vectors, hashes, the
    rows with a doubtful bucket per table, in-bucket positions."""

    def __init__(self, seg: Segment, bank, hashes: lsh.Hashes, cap: int,
                 m: int):
        self.sketch = seg.sketch
        ext = seg.ext.to(torch.int64)
        self.pos = torch.nonzero(ext >= 0, as_tuple=True)[0]
        self.ext = ext[self.pos]
        self.n = int(self.ext.shape[0])
        idx = self.ext                  # external id = row of the bank
        self.rows = bank[idx]
        self.b, self.f, self.a = (hashes.bucket[idx], hashes.flag[idx],
                                  hashes.alt[idx])
        self.doubt = [torch.nonzero(self.f[:, l] != lsh.CERTAIN,
                                    as_tuple=True)[0]
                      for l in range(self.b.shape[1])]
        if self.sketch:
            self.reg, self.rank = lsh.register_rank(self.pos, m)
            self.minb, self.maxb, self.minb_alt = self._positions(cap)

    def _positions(self, cap: int):
        """Per (row, table): certain rows before it in its bucket (the
        least it can sit at), every row that may sit before it (the
        most), and for a row with one doubtful bit the certain rows
        before it in the other bucket."""
        n, L = self.b.shape
        dev = self.b.device
        idx = torch.arange(n, dtype=torch.int64, device=dev)
        minb = torch.empty((n, L), dtype=torch.int64, device=dev)
        maxb = torch.empty_like(minb)
        minb_alt = torch.full_like(minb, 1 << 40)
        base = n + 1
        for l in range(L):
            b, f, a = self.b[:, l], self.f[:, l], self.a[:, l]
            order = torch.argsort(b, stable=True)
            sb = b[order]
            start = torch.searchsorted(sb, sb, right=False)
            pos_all = torch.empty_like(idx)
            pos_all[order] = idx - start
            minb[:, l] = pos_all
            maxb[:, l] = pos_all
            dl = self.doubt[l]
            if dl.numel() == 0:
                continue
            cert = (f[order] == lsh.CERTAIN).to(torch.int64)
            cum = torch.cumsum(cert, 0) - cert
            mb = torch.empty_like(idx)
            mb[order] = cum - cum[start]
            minb[:, l] = mb
            al = f == lsh.ONE_ALT
            akeys = torch.sort(a[al] * base + idx[al]).values
            before_al = (torch.searchsorted(akeys, b * base + idx)
                         - torch.searchsorted(akeys, b * base))
            wild = (f == lsh.WILD).to(torch.int64)
            maxb[:, l] = pos_all + before_al + torch.cumsum(wild, 0) - wild
            if bool(al.any()):
                c = f == lsh.CERTAIN
                ckeys = torch.sort(b[c] * base + idx[c]).values
                ua = a[al]
                minb_alt[al, l] = (
                    torch.searchsorted(ckeys, ua * base + idx[al])
                    - torch.searchsorted(ckeys, ua * base))
        return minb, maxb, minb_alt


def distances(q: torch.Tensor, rows: torch.Tensor, metric: str,
              precision: str = "float64"):
    """(Q, d) x (n, d) -> (Q, n) distances: float64 for the reference;
    the control's: cosine from TF32 inputs with float32 sums, L1 from
    bfloat16 inputs with float32 sums."""
    if metric == "cosine":
        if precision == "float64":
            qu = q.to(torch.float64)
            xu = rows.to(torch.float64)
        else:
            qu = lsh.round_mantissa(q / q.norm(dim=-1, keepdim=True)
                                    .clamp(min=1e-12), 10)
            xu = lsh.round_mantissa(rows / rows.norm(dim=-1, keepdim=True)
                                    .clamp(min=1e-12), 10)
        qu = qu / qu.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        xu = xu / xu.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        if precision != "float64":       # the rounded rows, not re-scaled
            qu = lsh.round_mantissa(qu, 10)
            xu = lsh.round_mantissa(xu, 10)
        return 1.0 - qu @ xu.T
    if metric != "l1":
        raise ValueError(f"metric {metric!r}")
    if precision == "float64":
        qq, xx = q.to(torch.float64), rows.to(torch.float64)
    else:
        qq, xx = lsh.round_mantissa(q, 7), lsh.round_mantissa(rows, 7)
    return torch.cdist(qq, xx, p=1)


class RefState:
    """The reference's view of an index: its segments, in the index's
    order, over the benchmark's data bank and hashes."""

    def __init__(self, segments: List[Segment], bank: torch.Tensor,
                 hashes: lsh.Hashes, cfg: dict, n_scan: int):
        self.cfg = cfg
        self.cap, self.m = int(cfg["cap"]), int(cfg["m"])
        self.segs = [_Seg(s, bank, hashes, self.cap, self.m)
                     for s in segments]
        self.n_scan = int(n_scan)

    def answer(self, qv: torch.Tensor, qh: lsh.Hashes, live_fn, r: float,
               precision: str = "float64"):
        """The reference's answer for queries ``qv`` (hashes ``qh``):
        per query the cost intervals, and per block the masks of rows a
        correct index may / must report.  Yields one dict per block of
        queries (``lo``, ``hi`` their range)."""
        cfg = self.cfg
        metric = cfg["metric"]
        alpha, beta = float(cfg["alpha"]), float(cfg["beta"])
        lives = [live_fn(s.ext) for s in self.segs]
        n_live = int(sum(int(x.sum()) for x in lives))
        n_rows = max(s.n for s in self.segs)
        qb = max(1, min(qv.shape[0], Q_BLOCK_ELEMS // max(n_rows, 1)))
        for lo in range(0, qv.shape[0], qb):
            hi = min(qv.shape[0], lo + qb)
            yield self._block(qv[lo:hi], lsh.Hashes(
                *(t[lo:hi] for t in qh)), lives, n_live, r, alpha, beta,
                metric, precision) | {"lo": lo, "hi": hi}

    def _block(self, qv, qh, lives, n_live, r, alpha, beta, metric,
               precision):
        nq = qv.shape[0]
        dev = qv.device
        f64 = torch.float64
        z = lambda: torch.zeros(nq, dtype=f64, device=dev)  # noqa: E731
        coll_lo, coll_hi, cand_lo, cand_hi = z(), z(), z(), z()
        dist_lo, per_seg = z(), []
        L = qh.bucket.shape[1]
        qdoubt = [torch.nonzero(qh.flag[:, l] != lsh.CERTAIN,
                                as_tuple=True)[0] for l in range(L)]
        for s, live in zip(self.segs, lives):
            sure_cnt = torch.zeros((nq, s.n), dtype=torch.int8, device=dev)
            poss_cnt = torch.zeros_like(sure_cnt)
            gsure = torch.zeros((nq, s.n), dtype=torch.bool, device=dev)
            gposs = torch.zeros_like(gsure)
            for l in range(L):
                eq = s.b[None, :, l] == qh.bucket[:, l, None]
                sure, poss, gp = eq, eq, None
                if s.sketch:
                    in_b = s.minb[:, l] < self.cap
                    gp = eq & in_b[None]
                dc, dq = s.doubt[l], qdoubt[l]
                if dc.numel() or dq.numel():
                    sure, poss = eq.clone(), eq.clone()
                    gp = None if gp is None else gp.clone()
                    self._doubt(s, l, qh, eq, sure, poss, gp, dc, dq)
                sure_cnt += sure
                poss_cnt += poss
                if s.sketch:
                    gsure |= sure & (s.maxb[:, l] < self.cap)[None]
                    gposs |= gp
            sure_any, poss_any = sure_cnt > 0, poss_cnt > 0
            dead = ~live
            c_lo = (sure_cnt * live[None]).sum(1, dtype=torch.int64)
            c_hi = (poss_cnt * live[None]).sum(1, dtype=torch.int64)
            if not s.sketch:
                gsure, gposs = sure_any, poss_any
                seg_lo = (sure_any & live[None]).sum(1).to(f64)
                seg_hi = (poss_any & live[None]).sum(1).to(f64)
            else:
                d_lo = (sure_cnt * dead[None]).sum(1, dtype=torch.int64)
                d_hi = (poss_cnt * dead[None]).sum(1, dtype=torch.int64)
                e_lo, e_hi = lsh.hll_interval(self._registers(s, sure_any),
                                              self._registers(s, poss_any))
                seg_lo = torch.clamp(e_lo - d_hi, min=0.0)
                seg_hi = torch.clamp(e_hi - d_lo, min=0.0)
            coll_lo += c_lo
            coll_hi += c_hi
            cand_lo += seg_lo
            cand_hi += seg_hi
            dist_lo += (sure_any & live[None]).sum(1)
            per_seg.append({"live": live, "gsure": gsure,
                            "gposs": gposs,
                            "d": distances(qv, s.rows, metric, precision),
                            "ext": s.ext, "sketch": s.sketch})
        cand_lo = torch.minimum(cand_lo, torch.clamp(coll_lo, max=n_live))
        cand_hi = torch.minimum(cand_hi, torch.clamp(coll_hi, max=n_live))
        return {"coll_lo": coll_lo, "coll_hi": coll_hi,
                "cand_lo": cand_lo, "cand_hi": cand_hi,
                "lsh_lo": alpha * coll_lo + beta * cand_lo,
                "lsh_hi": alpha * coll_hi + beta * cand_hi,
                "linear": beta * self.n_scan, "distinct": dist_lo,
                "segs": per_seg, "r": r}

    def _doubt(self, s: _Seg, l: int, qh, eq, sure, poss, gp, dc, dq):
        """Widen table l's masks where a row (columns ``dc``) or a query
        (rows ``dq``) has a doubtful bucket: such a pair is never sure,
        and possible in either bucket the boundary allows."""
        one, wild = lsh.ONE_ALT, lsh.WILD
        if dc.numel():
            f, a = s.f[dc, l], s.a[dc, l]
            sure[:, dc] = False
            alt = (f == one)[None] & (a[None] == qh.bucket[:, l, None])
            w = (f == wild)[None].expand_as(alt)
            poss[:, dc] |= alt | w
            if gp is not None:
                in_a = s.minb_alt[dc, l] < self.cap
                in_b = s.minb[dc, l] < self.cap
                gp[:, dc] |= (alt & in_a[None]) | (w & in_b[None])
        if dq.numel():
            qf, qa = qh.flag[dq, l, None], qh.alt[dq, l, None]
            sure[dq] = False
            q1 = qf == one
            eq_qa = q1 & (s.b[None, :, l] == qa)
            alt_qa = q1 & (s.f[None, :, l] == one) & (s.a[None, :, l] == qa)
            qw = (qf == wild).expand_as(eq_qa)
            poss[dq] |= eq_qa | alt_qa | qw
            if gp is not None:
                in_a = (s.minb_alt[:, l] < self.cap)[None]
                in_b = (s.minb[:, l] < self.cap)[None]
                gp[dq] |= ((eq_qa | qw) & in_b) | (alt_qa & in_a)

    def _registers(self, s: _Seg, mask: torch.Tensor) -> torch.Tensor:
        """(Q, m) HLL registers of each query's rows in ``mask``."""
        nq = mask.shape[0]
        regs = torch.zeros((nq, self.m), dtype=torch.int64,
                           device=mask.device)
        vals = torch.where(mask, s.rank[None], torch.zeros_like(s.rank)[None])
        regs.scatter_reduce_(1, s.reg[None].expand(nq, -1), vals, "amax")
        return regs


@dataclasses.dataclass
class Answer:
    """An index's answer to one query batch: the route and its terms per
    query, and every reported (query, external id, distance) triple."""
    use_lsh: torch.Tensor     # (Q,) bool
    collisions: torch.Tensor  # (Q,)
    cand: torch.Tensor        # (Q,)
    pair_q: torch.Tensor      # (P,) int64 query index
    pair_ext: torch.Tensor    # (P,) int64 external id
    pair_dist: torch.Tensor   # (P,) the distance reported with the pair


def control_answer(state: RefState, qv, qh, live_fn, r) -> Answer:
    """The reference in the program's place with TF32 / bfloat16
    distances: the route from its own costs (the lower end where ``qh``
    carries doubt), the rows it then reports, and their distances at
    that precision.  With point TF32 hashes (``state`` and ``qh``) it is
    the whole control; with the reference's own hashes only the
    distances are computed below the configuration's precision."""
    use, coll, cand, pq, pe, pd = [], [], [], [], [], []
    t = float(r)
    for blk in state.answer(qv, qh, live_fn, r, precision="control"):
        lsh_route = blk["lsh_lo"] < blk["linear"]
        use.append(lsh_route)
        coll.append(blk["coll_lo"])
        cand.append(blk["cand_lo"])
        for sg in blk["segs"]:
            allowed = sg["gsure"] | ~lsh_route[:, None]
            rep = allowed & sg["live"][None] & (sg["d"] <= t)
            qi, col = torch.nonzero(rep, as_tuple=True)
            pq.append(qi + blk["lo"])
            pe.append(sg["ext"][col])
            pd.append(sg["d"][qi, col])
    return Answer(torch.cat(use), torch.cat(coll), torch.cat(cand),
                  torch.cat(pq), torch.cat(pe), torch.cat(pd))


def judge(state: RefState, qv, qh, live_fn, r, ans: Answer) -> Dict:
    """Hold ``ans`` to the reference.  Returns the compared numbers
    (``report_gap``, ``distance_gap``, ``route_gap``, ``collision_excess``,
    ``estimate_gap``) with the counts they were taken over, and the
    misrouted share (Eq. 1 priced with exact counts)."""
    t = float(r)
    scale = max(1.0, abs(t))
    dev = qv.device
    f64 = torch.float64
    alpha, beta = float(state.cfg["alpha"]), float(state.cfg["beta"])
    all_ext = torch.cat([s.ext for s in state.segs])
    ext_max = int(max(int(all_ext.max()) if all_ext.numel() else 0,
                      int(ans.pair_ext.max()) if ans.pair_ext.numel()
                      else 0)) + 1
    where_seg = torch.full((ext_max,), -1, dtype=torch.int64, device=dev)
    where_col = torch.full((ext_max,), -1, dtype=torch.int64, device=dev)
    for k, s in enumerate(state.segs):
        where_seg[s.ext] = k
        where_col[s.ext] = torch.arange(s.n, device=dev)
    order = torch.argsort(ans.pair_q)
    pq = ans.pair_q[order]
    pe = ans.pair_ext[order]
    pdist = ans.pair_dist[order].to(f64)
    bad = (pe < 0) | (pe >= ext_max)
    pe = pe.clamp(0, ext_max - 1)
    p_seg = torch.where(bad, -1, where_seg[pe])
    p_col = where_col[pe]
    zero = torch.zeros((), dtype=f64, device=dev)
    gap, rgap, cex, egap, dgap = (zero.clone() for _ in range(5))
    gap = torch.where((p_seg < 0).any(), GAP_FOREIGN, gap)
    n_rep = torch.zeros((), dtype=torch.int64, device=dev)
    n_due, n_mis = n_rep.clone(), n_rep.clone()
    use = ans.use_lsh.to(torch.bool)
    bounds, step = None, 1
    nq_all = 0
    for blk in state.answer(qv, qh, live_fn, r):
        lo, hi = blk["lo"], blk["hi"]
        nq_all += hi - lo
        if bounds is None:            # blocks are [k * step, (k+1) * step)
            step = hi - lo
            edges = torch.arange(0, qv.shape[0] + step, step, device=dev)
            bounds = torch.searchsorted(pq, edges).tolist()
        a, b = bounds[lo // step], bounds[lo // step + 1]
        bq, bs, bc, bd = pq[a:b] - lo, p_seg[a:b], p_col[a:b], pdist[a:b]
        u = use[lo:hi]
        # the route: the program's choice must be one some reading allows
        lin = blk["linear"]
        rg = torch.where(u & (blk["lsh_lo"] >= lin), (blk["lsh_lo"] - lin) / lin,
                         torch.where(~u & (blk["lsh_hi"] < lin),
                                     (lin - blk["lsh_hi"]) / lin, 0.0))
        rgap = torch.maximum(rgap, rg.max())
        c = ans.collisions[lo:hi].to(f64)
        cex = torch.maximum(cex, torch.clamp(torch.maximum(
            blk["coll_lo"] - c, c - blk["coll_hi"]), min=0.0).max())
        e = ans.cand[lo:hi].to(f64)
        egap = torch.maximum(egap, (torch.clamp(torch.maximum(
            blk["cand_lo"] - e, e - blk["cand_hi"]), min=0.0)
            / torch.clamp(blk["cand_lo"], min=1.0)).max())
        best = alpha * blk["coll_lo"] + beta * blk["distinct"] < lin
        n_mis += (best != u).sum()
        for k, sg in enumerate(blk["segs"]):
            nq, n = sg["gsure"].shape
            if n == 0:
                continue
            flat = torch.where(bs == k, bq * n + bc, nq * n)
            rep = torch.zeros(nq * n + 1, dtype=torch.bool, device=dev)
            rep[flat] = True
            rep = rep[:-1].view(nq, n)
            live = sg["live"][None]
            allowed = torch.where(u[:, None], sg["gposs"], live) & live
            due = torch.where(u[:, None], sg["gsure"], live) & live \
                & (sg["d"] <= t)
            n_rep += rep.sum()
            n_due += due.sum()
            d = sg["d"]
            on = bs == k            # the distance each reported pair came with
            if bool(on.any()):
                dgap = torch.maximum(dgap, (bd[on] - d[bq[on], bc[on]])
                                     .abs().max() / scale)
            gap = torch.maximum(gap, torch.where(rep & ~allowed, GAP_FOREIGN,
                                                 0.0).max())
            gap = torch.maximum(gap, torch.where(rep & allowed & (d > t),
                                                 (d - t) / scale, 0.0).max())
            gap = torch.maximum(gap, torch.where(due & ~rep, (t - d) / scale,
                                                 0.0).max())
    out = {"report_gap": float(gap), "distance_gap": float(dgap),
           "route_gap": float(rgap),
           "collision_excess": float(cex), "estimate_gap": float(egap),
           "queries": nq_all, "pairs_reported": int(n_rep),
           "pairs_due": int(n_due), "misrouted": int(n_mis),
           "doubtful_queries": int((qh.flag != lsh.CERTAIN).any(1).sum())}
    out["misroute_pct"] = 100.0 * out["misrouted"] / max(nq_all, 1)
    return out


def batch_work(state: RefState, qv, qh, live_fn, r, use_lsh) -> Dict:
    """The least work one query batch needs of each route, from the
    reference's exact counts (sure readings only, so never too high):
    per route the queries, the rows read once, the candidate rows per
    query, the reported pairs, and the distinct probed buckets."""
    t = float(r)
    use = use_lsh.to(torch.bool)
    w = {"q_lsh": int(use.sum()), "q_linear": int((~use).sum()),
         "lsh_rows_union": 0, "lsh_cands": 0, "lsh_pairs": 0,
         "bucket_entries": 0, "linear_rows": 0, "linear_qrows": 0,
         "linear_pairs": 0,
         "probed_buckets": 0, "sketch_segments": 0, "d": int(qv.shape[1]),
         "L": int(qh.bucket.shape[1]), "m": state.m}
    unions = [None] * len(state.segs)
    for blk in state.answer(qv, qh, live_fn, r):
        u = use[blk["lo"]:blk["hi"]]
        for k, sg in enumerate(blk["segs"]):
            if not sg["sketch"]:
                continue
            g = sg["gsure"] & u[:, None]
            w["lsh_cands"] += int(g.sum())
            any_g = g.any(0)
            unions[k] = any_g if unions[k] is None else unions[k] | any_g
            w["lsh_pairs"] += int((g & sg["live"][None]
                                   & (sg["d"] <= t)).sum())
            lin = ~u[:, None] & sg["live"][None] & (sg["d"] <= t)
            w["linear_pairs"] += int(lin.sum())
    for k, s in enumerate(state.segs):
        if w["q_linear"]:
            rows = int(live_fn(s.ext).sum())
            w["linear_rows"] += rows
            w["linear_qrows"] += rows * w["q_linear"]
        if not s.sketch:
            continue
        w["sketch_segments"] += 1
        if unions[k] is not None:
            w["lsh_rows_union"] += int(unions[k].sum())
        certain = (qh.flag == lsh.CERTAIN)
        for l in range(w["L"]):
            bl = qh.bucket[:, l][certain[:, l]]
            w["probed_buckets"] += int(torch.unique(bl).numel())
            sizes = torch.bincount(s.b[:, l],
                                   minlength=int(state.cfg["num_buckets"]))
            got = sizes[qh.bucket[:, l][use & certain[:, l]]]
            w["bucket_entries"] += int(torch.clamp(got, max=state.cap).sum())
    return w
