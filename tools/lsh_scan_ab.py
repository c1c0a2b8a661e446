#!/usr/bin/env python3
"""Time the LSH verification (K2) and the L1 tile (K4, K7) against another
build of ``fused_scan.cu`` in one process.

    python3 tools/lsh_scan_ab.py --parent OLD/fused_scan.cu [--sass]   # on a CUDA machine

``--parent`` is a ``fused_scan.cu`` whose ``lsh_scan`` takes sorted ids and
their left shift (``prev``), as before the fused kernel (for example from
``git archive`` of that commit).  Both sources are built into
``build/lsh_scan_ab/``.  For each dataset's first 32-query chunk (the
analogues of ``chip_smoke.py``, full size: Webspam q0 and q3, Corel q2,
CoverType q3 on all rows, MNIST q0) the script takes the candidates as the
bucket gather leaves them and times, in alternating rounds,

  * parent: ``torch.sort`` of them, the ``prev`` shift and the parent's
    ``lsh_scan`` (what ``search.lsh_search`` ran before);
  * change: this tree's ``ops.fused_lsh_scan_unsorted`` on the card, which
    sorts, dedups and verifies in one kernel (for cosine on the corpus's
    unit rows, as the indexes run it);

and K4 (32 CoverType queries x 524,288 rows) and K7 (100 x 580,912), each
build swapped into the wrappers in turn.  ms per call from CUDA events around the
Python call, the L2 flushed before each, as ``chip_smoke.py`` times them,
and device ms of the same call captured in a CUDA graph and replayed
(without the host's launch work); the median and range of ``--rounds``
rounds, and the rounds the change won.  Before
timing it checks that both K2 builds report the same sets and that the
change's ids equal ``torch.sort``'s.  ``--sass`` prints the instruction
mix of this tree's ``l1_tile_kernel`` from ``cuobjdump -sass``: the FADDs
a term of ``acc += |q - x|`` takes.  ``--variants`` also times builds of
this tree's source with one piece of work taken out (``VARIANTS``); they
compute wrong results, or the same ones another way, and only their
times are read; their ptxas registers and spills of ``lsh_scan_kernel``
are printed beside.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))
SOURCE = ROOT / "src/repro_torch/kernels/csrc/fused_scan.cu"
OUT = ROOT / "build" / "lsh_scan_ab"
CASES = (("webspam", 0), ("webspam", 3), ("corel", 2), ("covertype", 3),
         ("mnist", 0))
VARIANTS = {
    # the L1 tile without its arithmetic (loads and epilogue stay)
    "l1_no_compute": ("    if (busy) {\n      const float* xs",
                      "    if (busy && a.Q < 0) {\n      const float* xs"),
    # the L1 tile without its global stores (loads and arithmetic stay)
    "l1_no_store": ("gn < a.N && ql < nq; ql +=", "gn < a.N && ql < nq && a.Q < 0; ql +="),
    # the L1 tile with 32-column chunks (rows of 36 words) and two blocks
    # an SM in the shared memory budget
    "l1_bk32_2blocks": ("constexpr int kL1BK = 16;               // d-columns of a ring stage\n"
                        "constexpr int kL1XS = kL1BK + 4;",
                        "constexpr int kL1BK = 32;               // d-columns of a ring stage\n"
                        "constexpr int kL1XS = kL1BK + 4;",
                        "constexpr int kL1BlocksPerSm = 4;", "constexpr int kL1BlocksPerSm = 2;"),
    # the L1 tile's distance stores marked streaming (evict first), so the
    # outputs do not push the corpus tiles of the other groups out of L2
    "l1_stcs": ("        *reinterpret_cast<float4*>(dd) = e4;",
                "        __stcs(reinterpret_cast<float4*>(dd), e4);"),
    # K2 with one block an SM: 128 registers a thread instead of 64 (the
    # kernel spills at 64), half the splits a query
    "lsh_1block": ("constexpr int kLshBlocksPerSm = 2;", "constexpr int kLshBlocksPerSm = 1;"),
    # K2 with blocks of 256 threads, two an SM: 128 registers, half the
    # threads an SM, the same splits
    "lsh_256x2": ("constexpr int kLshThreads = 512;", "constexpr int kLshThreads = 256;"),
    # K2 with 8 words of a row a lane in flight (twice the lanes a row)
    "lsh_words8": ("constexpr int kLshWords = 16;", "constexpr int kLshWords = 8;"),
    # K2 with two rows a lane group in flight (the loop over the distinct
    # rows takes two at a time)
    "lsh_rows2": ("""    for (int k0 = 0; k0 < nk; k0 += rows_at_once) {   // block-uniform
      const int kk = k0 + tid / a.group;
      const bool ok = kk < nk;
      const T* row = x + static_cast<int64_t>(lo + (ok ? rel[kk] : 0)) * a.d;
      const float v = row_dist<METRIC, VEC>(row, qs, a.d, lg, a.group, ok);
      if (ok && lg == 0) dist_s[kk] = v;
    }""", """    for (int k0 = 0; k0 < nk; k0 += 2 * rows_at_once) {
      const int kk = k0 + tid / a.group, kk2 = kk + rows_at_once;
      const bool ok = kk < nk, ok2 = kk2 < nk;
      const T* row = x + static_cast<int64_t>(lo + (ok ? rel[kk] : 0)) * a.d;
      const T* row2 = x + static_cast<int64_t>(lo + (ok2 ? rel[kk2] : 0)) * a.d;
      const float v = row_dist<METRIC, VEC>(row, qs, a.d, lg, a.group, ok);
      const float v2 = row_dist<METRIC, VEC>(row2, qs, a.d, lg, a.group, ok2);
      if (ok && lg == 0) dist_s[kk] = v;
      if (ok2 && lg == 0) dist_s[kk2] = v2;
    }"""),
    # K2 without the row gather and distances (ids, counts, writes stay)
    "lsh_no_gather": ("k0 < nk; k0 += rows_at_once",
                      "k0 < nk && a.Q < 0; k0 += rows_at_once"),
}
# the parent's lsh_scan metric codes (it also took cosine on x as 2)
PARENT_METRICS = {"l2": 0, "l1": 1, "cosine": 2, "hamming": 3}
FAMILY = {"webspam": ("cosine", 254, 65536), "corel": ("l2", 32, 32768),
          "covertype": ("l1", 54, 65536), "mnist": ("hamming", 64, 16384)}


def parent_lsh(lib, thresh, x, q, cands, metric):
    """The parent's LSH route on one chunk: sort, prev, its kernel."""
    import torch
    from repro_torch.kernels._build import stream
    ids = torch.sort(cands, dim=-1).values
    prev = torch.cat([torch.full_like(ids[:, :1], -1), ids[:, :-1]], dim=-1)
    nq, c = ids.shape
    dist = torch.empty((nq, c), dtype=torch.float32, device=x.device)
    mask = torch.empty((nq, c), dtype=torch.bool, device=x.device)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = lib.lsh_scan
    fn.argtypes = [I, P, P, P, P, ctypes.c_float, P, P, I, I, I, I, P]
    fn.restype = I
    err = fn(PARENT_METRICS[metric], x.data_ptr(), q.data_ptr(),
             ids.data_ptr(), prev.data_ptr(), float(thresh), dist.data_ptr(),
             mask.data_ptr(), nq, c, x.shape[0], x.shape[1], stream(x))
    if err:
        raise RuntimeError(f"parent lsh_scan: cudaError {err}")
    return ids, dist, mask


def chunk(name, qi, dev):
    """(x, the 100 queries, the first 32's unsorted candidates, thresh,
    metric, label) at radius q``qi``, as ``chip_smoke.py`` builds its
    index; x and the queries as the LSH kernel reads them (int32 bit views
    of the codes for Hamming)."""
    from chip_smoke import pick_radii
    from repro_torch.core import HybridLSHIndex
    from repro_torch.core.index import as_rows
    from repro_torch.core.lsh import make_family
    from repro_torch.core.lsh.tables import gather_candidates
    from repro_torch.data import paper_dataset, query_split
    from repro_torch.kernels import ops
    from repro_torch.u32 import as_i32
    x, metric = paper_dataset(name, scale=1.0, seed=0)
    x, q = query_split(x, n_queries=100, seed=0)
    r = pick_radii(x, metric)[qi]
    fam_metric, d, buckets = FAMILY[name]
    idx = HybridLSHIndex(make_family(fam_metric, d=d, L=20, r=r, delta=0.1),
                         seed=0, num_buckets=buckets, m=64, cap=256,
                         device=dev).build(x)
    q = as_rows(q, metric, dev)
    cands = gather_candidates(idx.tables, idx.bucket_ids(q[:32]), idx.cap,
                              idx.n).contiguous()
    xk = idx.x
    if metric == "hamming":
        xk, q = as_i32(xk), as_i32(q)
    return (xk.contiguous(), q.contiguous(), cands,
            ops.metric_radius_transform(metric, r), metric,
            f"K2 {name} q{qi} Q=32 C={cands.shape[1]} {metric}")


def sass_mix(lib_path: Path) -> None:
    """Instruction counts of each l1_tile_kernel in the library's SASS, and
    the order of the global loads (L), FP32 FMAs (F) and shuffles (S) in
    lsh_scan_kernel<cosine, 8-byte copies>, the Webspam gather."""
    from repro_torch.kernels._build import nvcc
    tool = Path(nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib_path)], check=True,
                          capture_output=True, text=True).stdout
    m = re.search(r"Function : (\S*lsh_scan_kernelILi2ELi2E\S*)\n(.*?)(?=\n\s*Function :|\Z)",
                  text, re.S)
    if m:
        seq = "".join("L" if " LDG" in line else "F" if " FFMA" in line
                      else "S" if " SHFL" in line else ""
                      for line in m.group(2).splitlines())
        print(f"[sass] lsh_scan_kernel<2,2> loads / FMAs / shuffles in order: {seq}",
              flush=True)
    for m in re.finditer(r"Function : (\S*l1_tile_kernel\S*)\n(.*?)(?=\n\s*Function :|\Z)",
                         text, re.S):
        ops = collections.Counter()
        abs_fadd = 0
        for line in m.group(2).splitlines():
            ins = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", line)
            if not ins:
                continue
            op = ins.group(1)
            ops[op.split(".")[0]] += 1
            if op.startswith("FADD") and "|" in line:
                abs_fadd += 1
        print(f"[sass] {m.group(1)}: {sum(ops.values())} instructions; FADD "
              f"{ops['FADD']} ({abs_fadd} with a |.| operand), FFMA "
              f"{ops['FFMA']}, FMNMX {ops['FMNMX']}, LDS {ops['LDS']}; top "
              + ", ".join(f"{k} {v}" for k, v in ops.most_common(8)), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, required=True,
                    help="a fused_scan.cu whose lsh_scan takes sorted ids")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--flush", choices=("write", "read"), default="write",
                    help="empty the L2 before each call by zeroing a 64 MB "
                    "buffer (dirty lines, as chip_smoke.py) or reading it")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("lsh_scan_ab: needs a CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import ptxas_table
    from dot_tile_ab import build, cuda_ms, graph_ms, report
    from repro_torch.core.search import dedupe_sorted
    from repro_torch.kernels import _build, distances, fused_scan, ops, ref
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    text = SOURCE.read_text()
    sources = {"change": text, "parent": args.parent.read_text()}
    if args.variants:
        for name, edits in VARIANTS.items():
            src = text
            for old, new in zip(edits[::2], edits[1::2]):
                assert src.count(old) == 1, (name, old)
                src = src.replace(old, new)
            sources[name] = src
    with ThreadPoolExecutor(len(sources)) as ex:
        libs = dict(ex.map(lambda kv: build(*kv, out=OUT), sources.items()))
    if args.sass:
        sass_mix(OUT / "change.so")
    for name in libs:
        rows = [r for r in ptxas_table((OUT / f"{name}.ptxas.log").read_text())
                if r[0].startswith("lsh_scan_kernel")]
        print(f"[ptxas {name}] lsh_scan_kernel<metric, copy width> registers, "
              f"spill stores/loads: " + ", ".join(
                  f"{r[0][len('lsh_scan_kernel'):]} {r[1]} {r[3]}" for r in rows),
              flush=True)

    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    if args.flush == "read":
        class _Read:                    # cuda_ms / graph_ms call .zero_()
            def zero_(self, buf=flush.view(torch.int32)):
                buf.sum()
        flush = _Read()
    cases = {}
    for name, qi in CASES:
        x, q, cands, thresh, metric, label = chunk(name, qi, dev)
        qc = q[:32].contiguous()
        xu = ref.unit_rows(x).contiguous() if metric == "cosine" else None
        r = thresh ** 0.5 if metric == "l2" else thresh
        _build._libs["fused_scan"] = libs["change"]
        a = ops.fused_lsh_scan_unsorted(x, cands, qc, r, metric, impl="cuda",
                                        x_unit=xu)
        b = parent_lsh(libs["parent"], thresh, x, qc, cands, metric)
        assert torch.equal(a[0], b[0]), f"{label}: ids differ from torch.sort's"
        off = a[2] != b[2]
        gap = (b[1][off] - thresh).abs()
        assert bool((gap <= 3e-4 + 3e-4 * abs(thresh)).all()), \
            f"{label}: masks differ off the threshold"
        distinct = int(dedupe_sorted(a[0], x.shape[0])[1].sum())
        print(f"[{label}] distinct {distinct}, reported {int(a[2].sum())}, "
              f"{int(off.sum())} masks differ near the threshold; plan "
              f"{fused_scan.lsh_scan_plan(x if xu is None else xu, *cands.shape)}",
              flush=True)
        fused = (lambda x=x, qc=qc, c=cands, r=r, m=metric, xu=xu:
                 ops.fused_lsh_scan_unsorted(x, c, qc, r, m, impl="cuda",
                                             x_unit=xu))
        cases[label] = {n: fused for n in libs}
        cases[label]["parent"] = (lambda x=x, qc=qc, c=cands, t=thresh, m=metric:
                                  parent_lsh(libs["parent"], t, x, qc, c, m))
        if name == "covertype":
            x_cover, q_cover = x, q
    q32, k4_rows = q_cover[:32].contiguous(), x_cover[:524288]
    t4 = float(ops.fused_linear_scan(q32, k4_rows, 1.0, "l1", impl="ref")[1]
               .median())
    for c, fn in (("K4 Q=32 N=524288 d=54", lambda: fused_scan.linear_scan_l1(
                      t4, q32, k4_rows)),
                  ("K7 Q=100 N=580912 d=54", lambda: distances.pairwise_l1(
                      q_cover, x_cover))):
        cases[c] = {n: fn for n in libs}

    names = list(libs)
    res = {(n, c): [] for n in names for c in cases}
    dev_res = {(n, c): [] for n in names for c in cases}
    for rnd in range(args.rounds):
        for name in (names if rnd % 2 == 0 else names[::-1]):
            _build._libs["fused_scan"] = libs[name]
            for c, fns in cases.items():
                res[(name, c)].append(cuda_ms(fns[name], flush))
                dev_res[(name, c)].append(graph_ms(fns[name], flush))
    _build._libs["fused_scan"] = libs["change"]
    print("K4 / K7 launch layout (change): "
          f"{fused_scan.l1_tile_plan(q32, k4_rows)}, "
          f"{fused_scan.l1_tile_plan(q_cover, x_cover)}", flush=True)
    print("-- ms of the Python call (CUDA events around it, as chip_smoke.py "
          "times kernels):", flush=True)
    report(res, names, cases)
    print("-- device ms (the same calls captured in a CUDA graph and "
          "replayed):", flush=True)
    report(dev_res, names, cases)
    return 0


if __name__ == "__main__":
    sys.exit(main())
