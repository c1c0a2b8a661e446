#!/usr/bin/env python3
"""Time builds of ``fused_scan.cu`` against each other in one process.

    python3 tools/dot_tile_ab.py --parent OLD/fused_scan.cu   # on a CUDA machine
    python3 tools/dot_tile_ab.py --other deep=build/deep/fused_scan.cu

Builds this tree's ``src/repro_torch/kernels/csrc/fused_scan.cu``, the
``--parent`` source (for example from ``git archive`` of the parent
commit) and variants of this tree's source that take one piece of the
dot-form tile's work out (``--variants``): ``no_mma`` (the three
``mma.sync`` passes replaced by a cheap use of the split fragments, so
the loads and splits stay), ``one_pass`` (the hi.hi' pass alone) and
``no_epilogue`` (the tile's stores skipped).  Each build is swapped into
the wrappers in turn, alternating which runs first, and the script
prints the median and range of each kernel at the main path's shapes
(K1, K4, K6, K7, random data of the Webspam and CoverType widths): ms
per launch from CUDA events, the L2 flushed before each launch, as
``chip_smoke.py`` times them.  The variants compute wrong distances and
only their times are read.  ``--other NAME=PATH`` (repeatable) adds any
other source, for example a plan tried beside this one.  At the retrieval service's width (Q = 32,
N = 8,192, d = 4,096 and 4,095, unit rows) each build that is not a
variant is first held against the plain version, and the plain version
and ``addmm`` are timed in the same rounds; each build's plan is printed.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
SOURCE = ROOT / "src/repro_torch/kernels/csrc/fused_scan.cu"
OUT = ROOT / "build" / "dot_tile_ab"

_PASSES = """#pragma unroll
      for (int f = 0; f < NF; ++f) mma_tf32(acc[f], al, bh[f][0], bh[f][1]);
#pragma unroll
      for (int f = 0; f < NF; ++f) mma_tf32(acc[f], ah, bl[f][0], bl[f][1]);
#pragma unroll
      for (int f = 0; f < NF; ++f) mma_tf32(acc[f], ah, bh[f][0], bh[f][1]);"""
VARIANTS = {
    "no_mma": (_PASSES, """#pragma unroll
      for (int f = 0; f < NF; ++f)
        acc[f][0] += __uint_as_float(ah[0] ^ al[1] ^ bh[f][0] ^ bl[f][1]);"""),
    "one_pass": (_PASSES, """#pragma unroll
      for (int f = 0; f < NF; ++f) mma_tf32(acc[f], ah, bh[f][0], bh[f][1]);"""),
    "no_epilogue": ("    if (c != chunks - 1) continue;\n",
                    "    if (c != chunks - 1 || a.Q > 0) continue;\n"),
}


def build(name: str, text: str, out: Path = OUT) -> tuple[str, ctypes.CDLL]:
    """nvcc ``text`` into ``out/name.so`` with the flags of ``_build``
    (ptxas' report in ``out/name.ptxas.log``) and load it."""
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / f"{name}.cu", out / f"{name}.so"
    src.write_text(text)
    from repro_torch.kernels._build import NVCC_FLAGS, nvcc
    r = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(lib), str(src)],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{r.stderr}")
    (out / f"{name}.ptxas.log").write_text(r.stderr + r.stdout)
    return name, ctypes.CDLL(str(lib))


def cuda_ms(fn, flush, iters=10) -> float:
    """Median device ms of ``fn`` from CUDA events, ``flush`` (a buffer
    larger than the L2) zeroed before each launch."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def graph_ms(fn, flush, iters=10) -> float:
    """Median device ms of ``fn`` captured once in a CUDA graph and
    replayed, ``flush`` zeroed before each replay: the kernels' own time,
    without the host's launch work that ``cuda_ms``'s events bracket too."""
    import torch
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    del graph
    return statistics.median(times)


def report(res, names, cases) -> None:
    """Median and range of each (build, case), and how often ``change``
    beat ``parent`` round for round."""
    for c in cases:
        for name in names:
            t = res[(name, c)]
            line = (f"{c} {name}: median {statistics.median(t):.4f} ms, range "
                    f"{min(t):.4f}-{max(t):.4f}")
            if name == "change" and "parent" in names:
                p = res[("parent", c)]
                line += (f"; faster than parent in "
                         f"{sum(a < b for a, b in zip(t, p))}/{len(t)} rounds")
            print(line, flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, help="another fused_scan.cu")
    ap.add_argument("--other", action="append", default=[],
                    metavar="NAME=PATH", help="another fused_scan.cu")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("dot_tile_ab: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build, distances, fused_scan, ref
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    text = SOURCE.read_text()
    sources = {"change": text}
    if args.parent:
        sources["parent"] = args.parent.read_text()
    for spec in args.other:
        name, path = spec.split("=", 1)
        sources[name] = Path(path).read_text()
    if args.variants:
        for name, (old, new) in VARIANTS.items():
            assert text.count(old) == 1, name
            sources[name] = text.replace(old, new)
    with ThreadPoolExecutor(len(sources)) as ex:
        libs = dict(ex.map(lambda kv: build(*kv), sources.items()))

    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    g = torch.Generator(device=dev).manual_seed(0)
    unit = lambda *shape: ref.unit_rows(  # noqa: E731
        torch.randn(*shape, device=dev, generator=g)).contiguous()
    qw, qw100, xw = unit(32, 254), unit(100, 254), unit(349900, 254)
    qp, xp = unit(64, 254), unit(4096, 254)
    e32 = qw.new_empty(32)
    ex = xw.new_empty(xw.shape[0])
    qr, xr = unit(32, 4096), unit(8192, 4096)
    qo, xo = unit(32, 4095), unit(8192, 4095)
    er = qr.new_empty(8192)
    lib_in = torch.ones((1, 1), device=dev)
    qc = torch.randn(32, 54, device=dev, generator=g)
    qc100 = torch.randn(100, 54, device=dev, generator=g)
    xc = torch.randn(580912, 54, device=dev, generator=g)
    cases = {
        "K1 Q=32 N=349900 d=254 cosine": lambda: fused_scan.linear_scan_dot(
            0.5, qw, xw, e32, ex, mode="cosine"),
        "K6 Q=100 N=349900 d=254 cosine": lambda: distances.pairwise_dot(
            qw100, xw, None, None, mode="cosine"),
        "K6 Q=64 N=4096 d=254 cosine": lambda: distances.pairwise_dot(
            qp, xp, None, None, mode="cosine"),
        "K4 Q=32 N=580912 d=54": lambda: fused_scan.linear_scan_l1(40.0, qc, xc),
        "K7 Q=100 N=580912 d=54": lambda: distances.pairwise_l1(qc100, xc),
        "K1 Q=32 N=8192 d=4096 cosine": lambda: fused_scan.linear_scan_dot(
            0.9, qr, xr, e32, er, mode="cosine"),
        "K1 Q=32 N=8192 d=4095 cosine": lambda: fused_scan.linear_scan_dot(
            0.9, qo, xo, e32, er, mode="cosine"),
    }
    wide = {"K1 Q=32 N=8192 d=4096 cosine": (qr, xr),
            "K1 Q=32 N=8192 d=4095 cosine": (qo, xo)}
    for name, lib in libs.items():
        _build._libs["fused_scan"] = lib
        for c, (q, x) in wide.items():
            print(f"{c} {name}: plan {fused_scan.dot_tile_plan(q, x)}",
                  flush=True)
            if name in VARIANTS:
                continue
            dist, mask, ids = cases[c]()
            want = ref.fused_linear_scan(q, x, 0.9, "cosine")
            assert torch.equal(ids, want[0].contiguous()), (name, c)
            err = float((dist - want[1]).abs().max())
            assert err < 1e-4, (name, c, err)
            print(f"{c} {name}: ids equal the plain version's, distances "
                  f"within {err:.3g}", flush=True)
    others = {
        "plain Q=32 N=8192 d=4096": lambda: ref.fused_linear_scan(
            qr, xr, 0.9, "cosine"),
        "addmm Q=32 N=8192 d=4096": lambda: torch.addmm(
            lib_in, qr, xr.T, alpha=-1),
    }
    res = {(n, c): [] for n in libs for c in cases}
    names = list(libs)
    for rnd in range(args.rounds):
        for name in (names if rnd % 2 == 0 else names[::-1]):
            _build._libs["fused_scan"] = libs[name]
            for c, fn in cases.items():
                res[(name, c)].append(cuda_ms(fn, flush))
    for c, fn in others.items():
        t = [cuda_ms(fn, flush) for _ in range(args.rounds)]
        print(f"{c}: median {statistics.median(t):.4f} ms, range "
              f"{min(t):.4f}-{max(t):.4f}", flush=True)
    report(res, names, cases)
    return 0


if __name__ == "__main__":
    sys.exit(main())
