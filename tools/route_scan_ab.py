#!/usr/bin/env python3
"""Time builds of the route estimate (K3) and the grouped Hamming scan (K5,
and K8, its one-segment case) against variants in one process.

    python3 tools/route_scan_ab.py [--rounds 10] [--parent OLD/fused_scan.cu]

(on a CUDA machine).  Builds this tree's ``hll_merge.cu`` and
``fused_scan.cu`` and variants of each that change one choice of the
design (``VARIANTS``), swaps each build into the wrappers in turn
(alternating which runs first) and prints, for each kernel at the churned
MNIST index's shapes, the median and range of the device ms of a CUDA
graph replay with the L2 flushed before each (``dot_tile_ab.graph_ms``)
and of CUDA events around the call (``cuda_ms``).  The inputs are random,
at the sizes ``chip_smoke.py``'s churned MNIST index had (L = 20,
B = 16,384, m = 64; frozen segments of 32,768, 16,384, 4,096 and 4,096
rows and a 4,097-row delta; W = 2; 100 queries); K8 at 100 x 59,900.
K5 is also timed as one-segment scans: the delta alone at 100 and 32
queries (what the LSH route of a streaming Hamming index launches for
the delta) and one 32-query chunk of the 59,900-row static corpus.
``--parent`` adds a parent's ``fused_scan.cu`` (from ``git archive``),
whose one-segment Hamming scan (``linear_scan_hamming(q, x, thresh, ...)``)
is timed on those one-segment shapes and whose K8 on its own.  Each build
is checked against the plain version before it is timed.  A yardstick is
timed beside them: ``zero_()`` of three tensors of K5's output shapes, the
same bytes written by PyTorch's fill kernel (what writing them alone
takes on this card).
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))
CSRC = ROOT / "src/repro_torch/kernels/csrc"
OUT = ROOT / "build" / "route_scan_ab"

# (source, old text, new text): one change each
VARIANTS = {
    # K3: one segment at a time (the groups of warps not side by side)
    "route_serial": ("hll_merge", "const int threads = group * std::min(a.nseg, 1024 / group);",
                     "const int threads = group;"),
    # K3: register loads a thread has in flight
    "route_batch1": ("hll_merge", "constexpr int kRouteBatch = 16;",
                     "constexpr int kRouteBatch = 1;"),
    "route_batch4": ("hll_merge", "constexpr int kRouteBatch = 16;",
                     "constexpr int kRouteBatch = 4;"),
    "route_batch32": ("hll_merge", "constexpr int kRouteBatch = 16;",
                      "constexpr int kRouteBatch = 32;"),
    # K5: queries a block, at most 16 / 8 (more blocks)
    "ham_q16": ("fused_scan", "constexpr int kHamQ = 32;", "constexpr int kHamQ = 16;"),
    "ham_q8": ("fused_scan", "constexpr int kHamQ = 32;", "constexpr int kHamQ = 8;"),
    # K5: threads a block (tiles of 1,024 / 256 rows)
    "ham_t256": ("fused_scan", "constexpr int kHamThreads = 128;",
                 "constexpr int kHamThreads = 256;"),
    "ham_t64": ("fused_scan", "constexpr int kHamThreads = 128;",
                "constexpr int kHamThreads = 64;"),
    # K5: plain stores instead of st.global.cs
    "ham_plain_stores": ("fused_scan", "constexpr int kHamThreads = 128;",
                         "#define __stcs(p, v) (*(p) = (v))\n"
                         "constexpr int kHamThreads = 128;"),
    # K5: blocks an SM the query shares aim at (0: ceil(Q / 32) shares)
    "ham_fill0": ("fused_scan", "constexpr int kHamFillPerSm = 2;",
                  "constexpr int kHamFillPerSm = 0;"),
    "ham_fill8": ("fused_scan", "constexpr int kHamFillPerSm = 2;",
                  "constexpr int kHamFillPerSm = 8;"),
    "ham_fill24": ("fused_scan", "constexpr int kHamFillPerSm = 2;",
                   "constexpr int kHamFillPerSm = 24;"),
}
SEG_ROWS = (32768, 16384, 4096, 4096)
DELTA_ROWS = 4097
L, B, M, Q, W = 20, 16384, 64, 100, 2


def inputs(torch, dev):
    """Random K3 tables and K5 parts at the churned MNIST shapes."""
    from repro_torch.kernels import ops
    g = torch.Generator(device=dev).manual_seed(0)
    tables, parts = [], []
    ext0 = 0
    for n in SEG_ROWS + (DELTA_ROWS,):
        if n != DELTA_ROWS:
            b = torch.randint(0, B, (L, n), device=dev, generator=g)
            counts = torch.zeros((L, B), dtype=torch.int64, device=dev)
            counts.scatter_add_(1, b, torch.ones_like(b))
            starts = torch.cat([torch.zeros((L, 1), dtype=torch.int64, device=dev),
                                counts.cumsum(1)], 1).to(torch.int32)
            regs = (torch.randint(1, 8, (L, B, M), device=dev, generator=g)
                    * (torch.rand((L, B, M), device=dev, generator=g) < 0.05)
                    ).to(torch.uint8)
            tomb = (counts // 20).to(torch.int32)
            tables.append(ops.TableTerms(starts, regs, tomb))
        x = torch.randint(-2**31, 2**31 - 1, (n, W), dtype=torch.int32,
                          device=dev, generator=g)
        live = torch.rand(n + 1, device=dev, generator=g) < 0.99
        ext = torch.arange(ext0, ext0 + n, dtype=torch.int32, device=dev)
        ext0 += n
        parts.append(ops.ScanPart(x, live, ext))
    qb = torch.randint(0, B, (Q, L), dtype=torch.int32, device=dev, generator=g)
    q = torch.randint(-2**31, 2**31 - 1, (Q, W), dtype=torch.int32, device=dev,
                      generator=g)
    xm = torch.randint(-2**31, 2**31 - 1, (59900, W), dtype=torch.int32,
                       device=dev, generator=g)
    return qb, tables, q, parts, xm


def parent_scan(thresh, q, x):
    """The parent's one-segment Hamming scan, as its wrapper called it
    (outputs allocated, one launch), through whichever ``fused_scan``
    build is swapped in."""
    import ctypes
    from repro_torch.kernels import _build, fused_scan
    _P, _I = ctypes.c_void_p, ctypes.c_int
    nq, nn = q.shape[0], x.shape[0]
    dist, mask, ids = fused_scan._linear_outputs(nq, nn, q.device)
    _build.launch("fused_scan", "linear_scan_hamming",
                  [_P, _P, ctypes.c_float, _P, _P, _P, _I, _I, _I, _P],
                  q.data_ptr(), x.data_ptr(), float(thresh), dist.data_ptr(),
                  mask.data_ptr(), ids.data_ptr(), nq, nn, q.shape[1],
                  _build.stream(q))
    return dist, mask, ids


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--parent", type=Path, default=None,
                    help="a parent's fused_scan.cu (one-segment K5 and K8)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("route_scan_ab: needs a CUDA device", file=sys.stderr)
        return 1
    from dot_tile_ab import build, cuda_ms, graph_ms
    from repro_torch.kernels import _build, fused_scan, hamming, hll_merge, ref
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    texts = {lib: (CSRC / f"{lib}.cu").read_text()
             for lib in ("hll_merge", "fused_scan")}
    sources = {f"{lib}:change": (lib, text) for lib, text in texts.items()}
    for name, (lib, old, new) in VARIANTS.items():
        assert texts[lib].count(old) == 1, name
        sources[f"{lib}:{name}"] = (lib, texts[lib].replace(old, new))
    if args.parent is not None:
        sources["fused_scan:parent"] = ("fused_scan", args.parent.read_text())
    with ThreadPoolExecutor(len(sources)) as ex:
        libs = dict(ex.map(lambda kv: build(kv[0].replace(":", "_"), kv[1][1], OUT),
                           sources.items()))
    libs = {k: libs[k.replace(":", "_")] for k in sources}

    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    qb, tables, q, parts, xm = inputs(torch, dev)
    thresh = 24.0
    xd = parts[-1].x                              # the delta's codes
    one_seg = {                                   # name -> (q, x)
        f"K5 delta Q={Q} W={W} N={xd.shape[0]}": (q, xd),
        f"K5 delta Q=32 W={W} N={xd.shape[0]}": (q[:32].contiguous(), xd),
        f"K5 chunk Q=32 W={W} N={xm.shape[0]}": (q[:32].contiguous(), xm)}

    def new_scan(qq, x):
        return lambda: fused_scan.linear_scan_hamming(thresh, qq, [ref.ScanPart(x)])

    def old_scan(qq, x):
        return lambda: parent_scan(thresh, qq, x)

    # name -> (this tree's and its variants' call, the parent's or None)
    cases = {
        "hll_merge": {
            f"K3 Q={Q} V={L} m={M} S={len(tables)}":
                (lambda: hll_merge.route_estimate(qb, tables), None)},
        "fused_scan": {
            f"K5 Q={Q} W={W} rows {sum(p.x.shape[0] for p in parts)} over "
            f"{len(parts)} segments":
                (lambda: fused_scan.linear_scan_hamming(thresh, q, parts), None),
            **{c: (new_scan(*a), old_scan(*a)) for c, a in one_seg.items()},
            f"K8 Q={Q} N={xm.shape[0]} W={W}":
                (lambda: hamming.hamming(q, xm),) * 2},
    }
    n = sum(p.x.shape[0] for p in parts)
    outs = [torch.empty((Q, n), dtype=dt, device=dev)
            for dt in (torch.float32, torch.int32, torch.bool)]
    cases["yardstick"] = {f"zero_() of (Q, {n}) f32, i32, bool":
                          (lambda: [t.zero_() for t in outs], None)}
    want = {"hll_merge": ref.route_estimate(qb, tables),
            "fused_scan": ref.grouped_linear_scan(q, parts, thresh, "hamming")}
    for key, lib in libs.items():        # each build right before it is timed
        name = key.split(":")[0]
        _build._libs[name] = lib
        if name == "hll_merge":
            coll, cand = hll_merge.route_estimate(qb, tables)
            assert torch.equal(coll, want[name][0]), key
            torch.testing.assert_close(cand, want[name][1], rtol=1e-5, atol=0)
            continue
        if key != "fused_scan:parent":
            d, m, i = fused_scan.linear_scan_hamming(thresh, q, parts)
            assert all(torch.equal(u, v) for u, v in zip((i, d, m), want[name])), key
        for qq, x in one_seg.values():
            i, d, m = ref.fused_linear_scan(qq, x, thresh, "hamming")
            got = (parent_scan if key == "fused_scan:parent" else
                   lambda t, a, b: fused_scan.linear_scan_hamming(t, a, [ref.ScanPart(b)])
                   )(thresh, qq, x)
            assert all(torch.equal(u, v) for u, v in zip(got, (d, m, i))), key
    res = {}
    keys = list(libs) + ["yardstick:"]
    for rnd in range(args.rounds):
        for key in (keys if rnd % 2 == 0 else keys[::-1]):
            name = key.split(":")[0]
            if key in libs:
                _build._libs[name] = libs[key]
            for c, fns in cases[name].items():
                fn = fns[1] if key == "fused_scan:parent" else fns[0]
                if fn is None:
                    continue
                res.setdefault((key, c), ([], []))
                res[(key, c)][0].append(graph_ms(fn, flush))
                res[(key, c)][1].append(cuda_ms(fn, flush))
    for lib, cs in cases.items():
        for c in cs:
            for key in keys:
                if key.split(":")[0] != lib or (key, c) not in res:
                    continue
                g, e = res[(key, c)]
                print(f"{c} {key}: device median {statistics.median(g):.4f} ms "
                      f"(range {min(g):.4f}-{max(g):.4f}), events median "
                      f"{statistics.median(e):.4f} (range {min(e):.4f}-"
                      f"{max(e):.4f})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
