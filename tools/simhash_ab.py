#!/usr/bin/env python3
"""Time builds of ``simhash.cu`` (K9) against each other in one process.

    python3 tools/simhash_ab.py --parent OLD/simhash.cu --variants   # on a CUDA machine

Builds this tree's ``src/repro_torch/kernels/csrc/simhash.cu``, the
``--parent`` source (for example from ``git archive`` of the parent
commit, into a directory ``.gitignore`` lists; a source without
``simhash_plan`` is called with the first design's interface: the padded
projection and lane columns a word) and variants of this tree's source
that take one piece out or swap one in (``--variants``, or ``--only`` a
few of them): ``no_mma`` (the three ``mma.sync`` passes replaced by a
cheap use of the split fragments, so the loads and splits stay),
``one_pass`` (the hi.hi' pass alone), ``no_epilogue`` (no ballots or
stores), ``chunk_loader`` (the cp.async ring of 32-column chunks where
the plan would take whole-row bulk copies), ``split_cvt`` (the split by
``cvt.rna.tf32.f32``, as the dot tile makes it), ``split_trunc`` (hi and
lo truncated, not rounded: two operations a split), ``no_split`` (the
raw bits as hi and lo: no split work), ``compute_only`` (each pair's
first tiles copied, then computed again and again: no wait for rows) and
``loads_only`` (the tiles copied, no k loop). At the Webspam shape (N =
349,900, d = 254, L = 20, k = 4; random data) it checks this tree's and
the parent's words against the plain version (bits only within the 1e-5
band), then times every build in rounds that alternate the order
(parent, change, ..., change, parent): device ms of a CUDA graph replay
and ms from CUDA events around the call, the L2 flushed before each. It
prints each build's median and range, ptxas' registers and spills, the
bound, and ``torch.matmul(x, R)`` and ``torch.sum(x)`` (a read of x)
beside them. The variants compute wrong words and only their times are
read.
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
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT))
SOURCE = ROOT / "src/repro_torch/kernels/csrc/simhash.cu"
OUT = ROOT / "build" / "simhash_ab"

_PASSES = """#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int f = 0; f < NFW; ++f) mma_tf32(acc[m][f], al[m], bh[f][0], bh[f][1]);
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int f = 0; f < NFW; ++f) mma_tf32(acc[m][f], ah[m], bl[f][0], bl[f][1]);
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int f = 0; f < NFW; ++f) mma_tf32(acc[m][f], ah[m], bh[f][0], bh[f][1]);"""
VARIANTS = {
    "no_mma": [(_PASSES, """#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int f = 0; f < NFW; ++f)
      acc[m][f][0] += __uint_as_float(ah[m][0] ^ al[m][1] ^ bh[f][0] ^ bl[f][1]);""")],
    "one_pass": [(_PASSES, """#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int f = 0; f < NFW; ++f) mma_tf32(acc[m][f], ah[m], bh[f][0], bh[f][1]);""")],
    "no_epilogue": [("      epilogue<NFW>(acc, my_balls, a, qd, pair, half, n0);\n",
                     "      if (a.N < 0) epilogue<NFW>(acc, my_balls, a, qd, pair, half, n0);\n")],
    "chunk_loader": [("  if (bulk >= 1) {\n", "  if (bulk >= 1 && d < 0) {\n")],
    "split_cvt": [("  hi = __float_as_uint(v) + 0x1000u;\n"
                   "  lo = __float_as_uint(v - __uint_as_float(hi & 0xffffe000u)) + 0x1000u;\n",
                   "  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(hi) : \"f\"(v));\n"
                   "  const float rest = v - __uint_as_float(hi);\n"
                   "  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(lo) : \"f\"(rest));\n")],
    "split_trunc": [("  hi = __float_as_uint(v) + 0x1000u;\n"
                     "  lo = __float_as_uint(v - __uint_as_float(hi & 0xffffe000u)) + 0x1000u;\n",
                     "  hi = __float_as_uint(v) & 0xffffe000u;\n"
                     "  lo = __float_as_uint(v - __uint_as_float(hi));\n")],
    "no_split": [("  hi = __float_as_uint(v) + 0x1000u;\n"
                  "  lo = __float_as_uint(v - __uint_as_float(hi & 0xffffe000u)) + 0x1000u;\n",
                  "  hi = __float_as_uint(v);\n  lo = hi;\n")],
    "compute_only": [("      mbar_wait(&full[s], (j / a.stages) & 1);\n",
                      "      if (j < a.stages) mbar_wait(&full[s], (j / a.stages) & 1);\n"),
                     ("      if (half == 0 && lane == 0 && j + a.stages < my_tiles)\n",
                      "      if (half == 0 && lane == 0 && j + a.stages < my_tiles && a.N < 0)\n")],
    "loads_only": [("      int k = 0;\n#pragma unroll 2\n",
                    "      int k = a.d;\n#pragma unroll 2\n")],
}
N, D, L, K = 349900, 254, 20, 4


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, help="another simhash.cu")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--only", help="comma-separated variants (default: all)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("simhash_ab: needs a CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import PEAKS, ptxas_table
    from dot_tile_ab import build, cuda_ms, graph_ms
    from repro_torch.kernels import ops, ref, simhash
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    text = SOURCE.read_text()
    sources = {"parent": args.parent.read_text()} if args.parent else {}
    sources["change"] = text
    if args.variants:
        only = set(args.only.split(",")) if args.only else set(VARIANTS)
        for name, edits in VARIANTS.items():
            if name not in only:
                continue
            v = text
            for old, new in edits:
                assert v.count(old) == 1, name
                v = v.replace(old, new)
            sources[name] = v
    with ThreadPoolExecutor(len(sources)) as ex:
        libs = dict(ex.map(lambda kv: build(*kv, out=OUT), sources.items()))
    for name in libs:
        for kernel, regs, smem, spills in ptxas_table(
                (OUT / f"{name}.ptxas.log").read_text()):
            print(f"[ptxas] {name} {kernel}: {regs} registers, {smem} B "
                  f"static shared memory, {spills} B spilled", flush=True)

    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(N, D, device=dev, generator=g)
    r = torch.randn(D, L * K, device=dev, generator=g)
    rp = ops.pad_projection(r, L, K).contiguous()
    rc = simhash.compact_projection(rp, L, K)
    lay = simhash.layout(L, K)
    out = torch.empty((N, L, lay.tw // L), dtype=torch.int32, device=dev)
    P, I = ctypes.c_void_p, ctypes.c_int

    def call(name):
        fn = libs[name].simhash
        if "simhash_plan" in sources[name]:
            fn.argtypes = [P] * 3 + [I] * 8 + [P]
            a = (x.data_ptr(), rc.data_ptr(), out.data_ptr(), N, D, lay.tw,
                 lay.npw, lay.wg, lay.wh, lay.nfw, lay.groups)
        else:                     # the first design: (d, TW * 32), kp
            fn.argtypes = [P] * 3 + [I] * 4 + [P]
            a = (x.data_ptr(), rp.data_ptr(), out.data_ptr(), N, D, lay.tw,
                 simhash.lanes_per_word(K))
        fn.restype = I

        def run():               # on the current stream (a graph's capture)
            err = fn(*a, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name}: cudaError {err}")
        return run

    runs = {name: call(name) for name in libs}
    plain = ref.simhash_fingerprint(x, rp, L, lay.tw // L)
    for name in ("change", "parent"):
        if name in runs:
            runs[name]()
            differ, far = ref.simhash_bits_differing(
                out.to(torch.int64) & 0xFFFFFFFF, plain, x, rp)
            assert far == 0, f"{name}: {far} bits differ away from 0"
            print(f"[check] {name}: {differ} bits differ from the plain "
                  f"version, all within {ref.SIMHASH_EPS:g} of 0", flush=True)
    del plain

    bw, _, tf32 = PEAKS["pcie" if "PCIe" in torch.cuda.get_device_name(0)
                        else "sxm"]
    nbytes = 4 * (N * D + D * L * K + N * lay.tw)
    tb, tt = nbytes / bw * 1e3, 3 * 2.0 * N * D * L * K / tf32 * 1e3
    print(f"[bound] N={N} d={D} L={L} k={K}: {nbytes / 1e6:.1f} MB {tb:.4f} "
          f"ms, 3xTF32 {tt:.4f} ms: {max(tb, tt):.4f} "
          f"({'bytes' if tb >= tt else 'operations'})", flush=True)
    names = list(runs)
    res = {(n, m): [] for n in names for m in ("device", "events")}
    mm, sums = [], []
    for rnd in range(args.rounds):
        for name in (names if rnd % 2 == 0 else names[::-1]):
            res[(name, "device")].append(graph_ms(runs[name], flush))
            res[(name, "events")].append(cuda_ms(runs[name], flush))
        mm.append(cuda_ms(lambda: torch.matmul(x, r), flush))
        sums.append(cuda_ms(lambda: torch.sum(x), flush))
    for m in ("device", "events"):
        for name in names:
            t = res[(name, m)]
            line = (f"K9 {m} {name}: median {statistics.median(t):.4f} ms, "
                    f"range {min(t):.4f}-{max(t):.4f}")
            if name != "parent" and "parent" in names:
                p = res[("parent", m)]
                line += (f"; faster than parent in "
                         f"{sum(a < b for a, b in zip(t, p))}/{len(t)} rounds")
            print(line, flush=True)
    for what, t in (("torch.matmul(x, R)", mm), ("torch.sum(x)", sums)):
        print(f"{what} events: median {statistics.median(t):.4f} ms, "
              f"range {min(t):.4f}-{max(t):.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
