#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU.

  python3 chip_smoke.py          # from the repository root, on a CUDA machine

Phases (each raises on failure, so any failure exits non-zero):
  1. card, torch and CUDA versions; build the CUDA kernels from
     ``src/repro_torch/kernels/csrc`` (one nvcc per source, in parallel);
  2. each kernel against its plain PyTorch version on hand-made edge cases;
  3. the main path at full scale — the Webspam analogue (N = 349,900,
     d = 254, cosine, L = 20) — built and queried through the kernels at
     four radii with force None / "lsh" / "linear", and again through the
     plain versions: neighbor sets, route containment, each path's own
     kernel launch counts (set to 0 before the path, read after it),
     query and kernel times;
  4. the same path in l2 on the Corel analogue at one radius;
  5. a ``{"kernels": [...]}`` JSON line with each kernel's launches, times,
     plain and library times and bound; then the last line
     ``{"ok": true, "device": {...}}``.

Neighbor sets may differ only in rows whose float64 distance lies within
1e-5 * max(1, |t|) of the threshold t: the kernel and the plain version
round float32 sums in different orders, and the absolute size of that
rounding follows the magnitude of the terms (about 1), not of t.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

THRESH_EPS = 1e-5
TOL = dict(rtol=3e-4, atol=3e-4)      # distances, kernel vs plain
HLL_RTOL = 1e-5
# Published H100 peaks (NVIDIA data sheet): memory bytes/s, fp32 FLOP/s
# on the CUDA cores.  SXM unless the card names itself PCIe.
PEAKS = {"sxm": (3.35e12, 67e12), "pcie": (2.0e12, 51e12)}

NOT_PORTED = [
    ("linear_scan_l1", "src/repro/kernels/fused_scan.py:177"),
    ("linear_scan_hamming", "src/repro/kernels/fused_scan.py:202"),
    ("pairwise_dot", "src/repro/kernels/distances.py:62"),
    ("pairwise_l1", "src/repro/kernels/distances.py:93"),
    ("hamming", "src/repro/kernels/hamming.py:33"),
    ("simhash", "src/repro/kernels/simhash.py:34"),
]


def log(*a):
    print(*a, flush=True)


def pick_radii(x, metric, n_radii=4, seed=0):
    """Radii at increasing output-size quantiles of the pairwise distance
    distribution (the benchmarks' rule)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    a = x[rng.integers(0, len(x), 2000)]
    b = x[rng.integers(0, len(x), 2000)]
    if metric == "l2":
        d = np.linalg.norm(a - b, axis=1)
    elif metric == "l1":
        d = np.abs(a - b).sum(1)
    else:
        d = 1.0 - (a * b).sum(1) / np.maximum(
            np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1), 1e-9)
    qs = np.quantile(d, [0.0005, 0.005, 0.03, 0.12][:n_radii])
    return [float(q) for q in qs]


class Smoke:
    def __init__(self):
        import numpy as np
        import torch
        from repro_torch.kernels import fused_scan, hll_merge
        self.np, self.torch = np, torch
        self.dev = torch.device("cuda")
        self.counters = {"linear_scan_dot": fused_scan.linear_scan_dot,
                         "lsh_scan": fused_scan.lsh_scan,
                         "hll_merge_estimate": hll_merge.hll_merge_estimate}
        name = torch.cuda.get_device_name(0)
        self.bw, self.fp32 = PEAKS["pcie" if "PCIe" in name else "sxm"]
        self.flush_buf = torch.empty(64 << 20, dtype=torch.uint8,
                                     device=self.dev)

    # -- counters -----------------------------------------------------
    def reset(self):
        for fn in self.counters.values():
            fn.launches = 0

    def read(self):
        return {k: fn.launches for k, fn in self.counters.items()}

    # -- timing -------------------------------------------------------
    def cuda_ms(self, fn, iters=10):
        """Median device ms of ``fn``, L2 flushed before each launch."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            self.flush_buf.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)

    def bound_ms(self, nbytes, flops):
        tb, tf = nbytes / self.bw * 1e3, flops / self.fp32 * 1e3
        return max(tb, tf), ("bytes" if tb >= tf else "operations")

    # -- comparisons ----------------------------------------------------
    def masks_agree(self, mk, mp, dist_plain, thresh, what):
        """Kernel and plain report masks may differ only where the plain
        distance is within the distance tolerance of the threshold."""
        off = mk != mp
        if bool(off.any()):
            gap = (dist_plain[off] - thresh).abs()
            lim = TOL["atol"] + TOL["rtol"] * abs(thresh)
            assert bool((gap <= lim).all()), f"{what}: masks differ off the threshold"
            log(f"[{what}] {int(off.sum())} mask entries differ within "
                f"{lim:.1e} of the threshold")

    def dist64(self, metric, q, rows):
        np = self.np
        q = q.astype(np.float64)
        rows = rows.astype(np.float64)
        if metric == "l2":
            return ((rows - q) ** 2).sum(1)
        qn = q / max(np.linalg.norm(q), 1e-12)
        rn = rows / np.maximum(np.linalg.norm(rows, axis=1, keepdims=True),
                               1e-12)
        return 1.0 - rn @ qn

    def off_threshold(self, ids, metric, xq, x, r):
        """Count of ``ids`` away from the threshold (must be 0)."""
        np = self.np
        if not ids:
            return 0
        t = r * r if metric == "l2" else r
        d = self.dist64(metric, xq, x[np.fromiter(ids, np.int64)])
        return int((np.abs(d - t) > THRESH_EPS * max(1.0, abs(t))).sum())

    def compare_sets(self, a, b, metric, q, x, r, what, subset=False):
        """a == b (or a <= b) up to near-threshold rows; returns the
        number of near-threshold exceptions used."""
        near = 0
        for i in a:
            extra = a[i] - b[i]
            missing = set() if subset else b[i] - a[i]
            bad = self.off_threshold(extra | missing, metric, q[i], x, r)
            if bad:
                raise AssertionError(f"{what}: query {i} differs in {bad} "
                                     f"rows away from the threshold")
            near += len(extra | missing)
        return near


# ---------------------------------------------------------------------------
def phase_build(s: Smoke):
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    built = _build.build(["hll_merge", "fused_scan"])
    log(f"[build] nvcc wall {time.perf_counter() - t0:.1f} s, per source "
        + ", ".join(f"{k} {sec:.1f} s" for k, (sec, _) in built.items()))
    for name, (_, text) in built.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    for name in ("hll_merge", "fused_scan"):
        _build.load(name)


def phase_edge_cases(s: Smoke):
    """Kernels vs plain versions on hand-made cases (small, odd shapes)."""
    np, torch, dev = s.np, s.torch, s.dev
    from repro_torch.kernels import ops
    rng = np.random.default_rng(0)
    radii = {"l2": 7.0, "l1": 55.0, "cosine": 0.9, "hamming": 300.0}

    def pair(metric, q, n, d=37):
        if metric == "hamming":
            return (torch.from_numpy(rng.integers(-2**31, 2**31, (q, 3),
                                                  dtype=np.int64)
                                     .astype(np.int32)).to(dev),
                    torch.from_numpy(rng.integers(-2**31, 2**31, (n, 3),
                                                  dtype=np.int64)
                                     .astype(np.int32)).to(dev))
        return (torch.from_numpy(rng.normal(size=(q, d)).astype(np.float32)).to(dev),
                torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(dev))

    for metric in ("l2", "cosine"):
        for q, n, d in ((8, 100, 37), (33, 257, 37), (65, 1000, 254),
                        (1, 129, 1)):
            qa, xa = pair(metric, q, n, d)
            a = ops.fused_linear_scan(qa, xa, radii[metric], metric, impl="cuda")
            b = ops.fused_linear_scan(qa, xa, radii[metric], metric, impl="ref")
            assert torch.equal(a[0], b[0].contiguous())
            assert torch.equal(a[2], b[2]), (metric, q, n)
            torch.testing.assert_close(a[1], b[1], **TOL)
    sent = 40
    hand = torch.tensor(np.sort(np.array([
        [0, 0, 0, 1, 2, 2, 5, sent], [3, 7, 7, 9, sent, sent, sent, sent],
        [sent] * 8], np.int32), axis=-1), device=dev)
    for metric in ("l2", "l1", "cosine", "hamming"):
        qa, xa = pair(metric, 3, sent, 254 if metric != "hamming" else 37)
        a = ops.fused_lsh_scan(xa, hand, qa, radii[metric], metric, impl="cuda")
        b = ops.fused_lsh_scan(xa, hand, qa, radii[metric], metric, impl="ref")
        assert torch.equal(a[2], b[2]), metric
        assert not bool(a[2][2].any())
        torch.testing.assert_close(a[1][a[2]], b[1][b[2]], **TOL)
        # odd Q and sentinel tails on random sorted candidates
        qa, xa = pair(metric, 7, 500, 254 if metric != "hamming" else 37)
        ids = torch.sort(torch.from_numpy(rng.integers(0, 560, (7, 300))
                                          .astype(np.int32)).to(dev)).values
        ids = torch.clamp(ids, max=500)
        a = ops.fused_lsh_scan(xa, ids, qa, radii[metric], metric, impl="cuda")
        b = ops.fused_lsh_scan(xa, ids, qa, radii[metric], metric, impl="ref")
        assert torch.equal(a[2], b[2]), metric
        torch.testing.assert_close(a[1][a[2]], b[1][b[2]], **TOL)
    for q, L, m, lo, hi in ((8, 3, 32, 0, 25), (100, 20, 64, 0, 20),
                            (7, 4, 64, 0, 2), (6, 2, 64, 23, 25),
                            (5, 1, 16, 0, 9), (3, 2, 1024, 0, 30)):
        regs = torch.from_numpy(rng.integers(lo, hi, (q, L, m))
                                .astype(np.uint8)).to(dev)
        if hi == 2:                          # small range: mostly zeros
            regs[:, :, m // 8:] = 0
        a = ops.hll_merge_estimate(regs, impl="cuda")
        b = ops.hll_merge_estimate(regs, impl="ref")
        torch.testing.assert_close(a, b, rtol=HLL_RTOL, atol=0)
    torch.cuda.synchronize()
    log("[edge] K1 (l2, cosine), K2 (l2, l1, cosine, hamming), K3 match "
        "their plain versions on the hand-made cases")


PATHS = {None: "hybrid", "lsh": "lsh", "linear": "linear"}


def check_path_launches(launches, n_lsh, n_linear, what):
    """Each kernel launches on a path exactly when that path has work for
    it: K3 for every batch, K2 when queries go to LSH, K1 when queries go
    to the linear scan."""
    want = {"hll_merge_estimate": True, "lsh_scan": n_lsh > 0,
            "linear_scan_dot": n_linear > 0}
    for k, needed in want.items():
        got = launches[k]
        assert (got > 0) == needed, (
            f"{what}: kernel {k} launched {got} times with {n_lsh} queries "
            f"routed to LSH and {n_linear} to the linear scan")


def drive(s: Smoke, x_np, q_np, metric, fam, idx_kw, r, tag):
    """Build one index, query it with force None / "lsh" / "linear"
    through the kernels (the launch counts set to 0 just before each
    path and read just after it) and through the plain versions, check
    the results and time the hybrid query.  Returns the index, the
    per-path launch counts and the hybrid route mix."""
    np, torch = s.np, s.torch
    from repro_torch.core import HybridLSHIndex
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = HybridLSHIndex(fam, seed=0, **idx_kw).build(x_np)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    plain = HybridLSHIndex(fam, params=idx.params, impl="ref", **idx_kw)
    plain.x, plain.tables = idx.x, idx.tables

    nq = len(q_np)
    res, launches = {}, {}
    for f, path in PATHS.items():
        s.reset()
        res[f] = idx.query(q_np, r, force=f)
        torch.cuda.synchronize()
        launches[path] = s.read()
    n_lsh = len(res[None].lsh_idx)
    check_path_launches(launches["hybrid"], n_lsh, nq - n_lsh,
                        f"{tag} hybrid")
    check_path_launches(launches["lsh"], nq, 0, f"{tag} lsh")
    check_path_launches(launches["linear"], 0, nq, f"{tag} linear")

    ref_res = {f: plain.query(q_np, r, force=f) for f in (None, "lsh", "linear")}
    sets = {f: v.neighbor_sets() for f, v in res.items()}
    ref_sets = {f: v.neighbor_sets() for f, v in ref_res.items()}
    # the kernel and plain HLL estimates agree to 1e-5, so routes may
    # differ only at a cost tie; compare hybrid sets where routes agree
    kr, pr = res[None].route, ref_res[None].route
    split = (kr.use_lsh != pr.use_lsh).cpu().numpy()
    tie = ((pr.lsh_cost - pr.linear_cost).abs()
           <= 1e-5 * pr.linear_cost).cpu().numpy()
    assert not (split & ~tie).any(), f"{tag}: routes differ off a cost tie"
    same = [i for i in range(len(split)) if not split[i]]
    near = {"route ties": int(split.sum())}
    for f in (None, "lsh", "linear"):
        a, b = sets[f], ref_sets[f]
        if f is None:
            a, b = {i: a[i] for i in same}, {i: b[i] for i in same}
        near[f"kernel=plain {f}"] = s.compare_sets(
            a, b, metric, q_np, x_np, r, f"{tag} force={f}")
    near["lsh<=linear"] = s.compare_sets(sets["lsh"], sets["linear"], metric,
                                         q_np, x_np, r, f"{tag} lsh<=linear",
                                         subset=True)
    use = res[None].route.use_lsh.cpu().numpy()
    routed = {i: sets["lsh"][i] if use[i] else sets["linear"][i]
              for i in range(len(use))}
    near["hybrid=route"] = s.compare_sets(sets[None], routed, metric, q_np,
                                          x_np, r, f"{tag} hybrid=route")
    for f, v in res.items():
        for out in (v.lsh_out, v.lin_out):
            if out is not None:
                assert bool(torch.isfinite(out[1][out[2]]).all()), (tag, f)

    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = idx.query(q_np, r)
        for o in (out.lsh_out, out.lin_out):
            if o is not None:
                o[2].sum().item()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    sizes = [len(v) for v in sets[None].values()]
    log(f"[{tag}] r={r:.6g} k={fam.k} build {t_build:.3f} s; route mix "
        f"{int(use.sum())} lsh / {len(use) - int(use.sum())} linear; "
        f"output size mean {np.mean(sizes):.1f} max {max(sizes)}; "
        f"hybrid query median of 5 {statistics.median(times) * 1e3:.2f} ms "
        f"(host clock, synchronised); launches {launches}; "
        f"near-threshold exceptions {near}")
    return idx, launches, (n_lsh, nq - n_lsh)


def kernel_times(s: Smoke, idx, q_np, r, metric):
    """Per-kernel ms, plain ms, library ms and bound at the main path's
    shapes: one 32-query chunk for the scans, the whole batch for K3."""
    np, torch = s.np, s.torch
    from repro_torch.core.lsh.tables import gather_candidates, gather_registers
    from repro_torch.kernels import fused_scan, hll_merge, ops, ref
    x = idx.x
    n, d = x.shape
    q_all = torch.from_numpy(q_np).to(s.dev)
    qc = q_all[:32].contiguous()
    thresh = ops.metric_radius_transform(metric, r)
    out = {}

    # K1: linear scan on the (pre-normalised for cosine) chunk and corpus
    if metric == "cosine":
        qk, xk = ref.unit_rows(qc).contiguous(), ref.unit_rows(x).contiguous()
        qn, xn = qk.new_empty(32), xk.new_empty(n)
        lib_in = torch.ones((1, 1), device=s.dev)
        lib = lambda: torch.addmm(lib_in, qk, xk.T, alpha=-1)  # noqa: E731
        in_bytes = 4 * (qk.numel() + xk.numel())
    else:
        qk, xk = qc, x
        qn, xn = (qk * qk).sum(-1), (xk * xk).sum(-1)
        lib_in = qn[:, None] + xn[None, :]
        lib = lambda: torch.addmm(lib_in, qk, xk.T, alpha=-2)  # noqa: E731
        in_bytes = 4 * (qk.numel() + xk.numel() + 32 + n)
    kern = lambda: fused_scan.linear_scan_dot(thresh, qk, xk, qn, xn,  # noqa: E731
                                              mode=metric)
    plain = lambda: ref.fused_linear_scan(qk, xk, thresh, metric)  # noqa: E731
    a, b = kern(), plain()              # (dist, mask, ids) / (ids, dist, mask)
    err = float((a[0] - b[1]).abs().max())
    assert torch.equal(a[2], b[0].contiguous())
    torch.testing.assert_close(a[0], b[1], **TOL)
    s.masks_agree(a[1], b[2], b[1], thresh, "linear_scan_dot")
    bound, by = s.bound_ms(in_bytes + 9 * 32 * n, 2.0 * 32 * n * d)
    x_unit = xk if metric == "cosine" else None    # as the index keeps it
    ops_ms = s.cuda_ms(lambda: ops.fused_linear_scan(qc, x, r, metric,
                                                     impl="cuda",
                                                     x_unit=x_unit))
    out["linear_scan_dot"] = dict(
        ms=s.cuda_ms(kern), plain_ms=s.cuda_ms(plain), library_ms=s.cuda_ms(lib),
        bound_ms=bound, bound_by=by, max_abs_err=err,
        shape=f"Q=32 N={n} d={d} {metric}", ops_ms=ops_ms)

    # K2: LSH verification on the first chunk's real candidates
    qb = idx.bucket_ids(qc)
    cands = gather_candidates(idx.tables, qb, idx.cap, n)
    ids = torch.sort(cands, dim=-1).values.contiguous()
    prev = torch.cat([torch.full((32, 1), -1, dtype=ids.dtype, device=s.dev),
                      ids[:, :-1]], dim=-1).contiguous()
    distinct = int(((ids != prev) & (ids < n)).sum())
    kern = lambda: fused_scan.lsh_scan(thresh, x, qc, ids, prev,  # noqa: E731
                                       metric=metric)
    plain = lambda: ref.fused_lsh_scan(x, ids, prev, qc, thresh, metric)  # noqa: E731
    a, b = kern(), plain()              # (dist, mask) / (ids, dist, mask)
    s.masks_agree(a[1], b[2], b[1], thresh, "lsh_scan")
    both = a[1] & b[2]
    err = float((a[0][both] - b[1][both]).abs().max()) if bool(both.any()) else 0.0
    c = ids.shape[1]
    flops_per = 6 if metric == "cosine" else 3
    bound, by = s.bound_ms(distinct * d * 4 + 2 * 4 * 32 * c + 4 * 32 * d
                           + 5 * 32 * c, flops_per * distinct * d)
    out["lsh_scan"] = dict(
        ms=s.cuda_ms(kern), plain_ms=s.cuda_ms(plain), library_ms=None,
        bound_ms=bound, bound_by=by, max_abs_err=err,
        shape=f"Q=32 C={c} distinct={distinct} d={d} {metric}")

    # K3: HLL merge + estimate over the whole batch's registers
    regs = gather_registers(idx.tables, idx.bucket_ids(q_all)).contiguous()
    kern = lambda: hll_merge.hll_merge_estimate(regs)  # noqa: E731
    plain = lambda: ref.hll_merge_estimate(regs)  # noqa: E731
    a, b = kern(), plain()
    torch.testing.assert_close(a, b, rtol=HLL_RTOL, atol=0)
    q, L, m = regs.shape
    bound, by = s.bound_ms(q * L * m + 4 * q, q * L * m + 3 * q * m)
    out["hll_merge_estimate"] = dict(
        ms=s.cuda_ms(kern), plain_ms=s.cuda_ms(plain), library_ms=None,
        bound_ms=bound, bound_by=by, max_abs_err=float((a - b).abs().max()),
        shape=f"Q={q} L={L} m={m}")
    return out


def log_kernel_times(tag, kt):
    for k, v in kt.items():
        lib = "none" if v["library_ms"] is None else f"{v['library_ms']:.4f}"
        log(f"[{tag}] {k}: {v['ms']:.4f} ms, plain {v['plain_ms']:.4f}, "
            f"library {lib}, bound {v['bound_ms']:.3g} ({v['bound_by']}), "
            f"max abs err {v['max_abs_err']:.3g}; {v['shape']}")
        if "ops_ms" in v:
            log(f"[{tag}] {k} through ops (normalisation, norms, kernel): "
                f"{v['ops_ms']:.4f} ms")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on a "
              "GPU", file=sys.stderr)
        return 1
    import numpy as np
    from repro_torch.core import PAPER_PRESETS
    from repro_torch.core.lsh import make_family
    from repro_torch.data import paper_dataset, query_split

    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    log(smi)
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    s = Smoke()
    phase_build(s)
    phase_edge_cases(s)

    # -- 3. Webspam analogue, full scale --------------------------------
    t0 = time.perf_counter()
    x, metric = paper_dataset("webspam", scale=1.0, seed=0)
    x, q = query_split(x, n_queries=100, seed=0)
    log(f"[webspam] N={x.shape[0]} d={x.shape[1]} {metric}, 100 queries "
        f"(data {time.perf_counter() - t0:.1f} s)")
    radii = pick_radii(x, metric)
    kw = dict(num_buckets=65536, m=64, cap=256,
              cost_model=PAPER_PRESETS["webspam"], device="cuda")
    by_path, mixed = {}, None
    for i, r in enumerate(radii):
        fam = make_family("cosine", d=254, L=20, r=r, delta=0.1)
        idx, launches, (n_lsh, n_lin) = drive(s, x, q, metric, fam, kw, r,
                                              f"webspam q{i}")
        by_path[f"webspam q{i}"] = launches
        if n_lsh and n_lin:
            mixed = i
        if i == 0:
            mem = idx.memory_stats()
            log(f"[webspam] device memory: corpus {idx.x.numel() * 4 / 1e6:.1f}"
                f" MB, registers {mem['hll_bytes'] / 1e6:.1f} MB, perm "
                f"{mem['perm_bytes'] / 1e6:.1f} MB, starts "
                f"{mem['starts_bytes'] / 1e6:.1f} MB")
        kt = kernel_times(s, idx, q, r, metric)
        log_kernel_times(f"webspam q{i}", kt)
        if mixed == i:
            timings = kt
        del idx
        torch.cuda.empty_cache()
    assert mixed is not None, "webspam: the hybrid mixed routes at no radius"
    # the main path: the hybrid query at the radius where it mixes routes,
    # so that it runs all three kernels
    main_launches = by_path[f"webspam q{mixed}"]["hybrid"]
    for k, v in main_launches.items():
        assert v > 0, f"webspam q{mixed}: kernel {k} was not launched"

    # -- 4. Corel analogue, l2, one mid radius --------------------------
    x2, metric2 = paper_dataset("corel", scale=1.0, seed=0)
    x2, q2 = query_split(x2, n_queries=100, seed=0)
    r2 = pick_radii(x2, metric2)[2]
    fam2 = make_family("l2", d=32, L=20, r=r2, delta=0.1)
    kw2 = dict(num_buckets=32768, m=64, cap=256,
               cost_model=PAPER_PRESETS["corel"], device="cuda")
    idx2, by_path["corel"], _ = drive(s, x2, q2, metric2, fam2, kw2, r2,
                                      "corel")
    log_kernel_times("corel", kernel_times(s, idx2, q2, r2, metric2))

    # -- 5. summary lines -----------------------------------------------
    src = {"linear_scan_dot": ("src/repro_torch/kernels/csrc/fused_scan.cu",
                               "src/repro/kernels/fused_scan.py:145"),
           "lsh_scan": ("src/repro_torch/kernels/csrc/fused_scan.cu",
                        "src/repro/kernels/fused_scan.py:272"),
           "hll_merge_estimate": ("src/repro_torch/kernels/csrc/hll_merge.cu",
                                  "src/repro/kernels/hll_merge.py:43")}
    kernels = []
    for name, (source, replaces) in src.items():
        t = timings[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": main_launches[name],
                        "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"],
                        "library_ms": t["library_ms"],
                        "main_path": f"webspam q{mixed} hybrid",
                        "launches_by_path": {
                            cell: {path: c[name] for path, c in paths.items()}
                            for cell, paths in by_path.items()}})
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels,
                    "not_ported": [{"name": n, "replaces": r}
                                   for n, r in NOT_PORTED]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
