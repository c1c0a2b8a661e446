"""Readings that a cell's check limits are set from, at the cell's size.

    python3 bench/control.py --workload <cell> --seeds 1,2,3 [--seconds 2]

For each seed, in one process: a run of the cell with a short window,
its judged batches held to the reference (the program's readings, the
lower ones), and the same batches answered by the control, the
reference in the program's place at the precision below the
configuration's (TF32 projections and cosine dots, bfloat16 L1 rows),
held to the reference too (the upper readings).  Prints one JSON line a
seed and, last, the largest program reading and the smallest control
reading of each number.  Needs a CUDA device; the benchmark's own runs
never run the control.
"""
from __future__ import annotations

import argparse
import io
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    a = p.parse_args(argv)
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        q for q in sys.path if Path(q or ".").resolve() != ROOT / "bench"]
    import torch

    from bench.lib import harness
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    lo, hi = {}, {}
    for seed in (int(s) for s in a.seeds.split(",")):
        err = io.StringIO()
        res = harness.run_cell(ROOT, a.workload, seed, a.seconds, False,
                               "cuda", control=True, err=err)
        prog = {k: v["value"] for k, v in res["checks"].items()}
        ctl = res["control"]
        for k, v in prog.items():
            lo[k] = max(lo.get(k, 0.0), v)
        for k, v in ctl.items():
            hi[k] = min(hi.get(k, float("inf")), v)
        info = [ln for ln in err.getvalue().splitlines()
                if ln.startswith("info ")]
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "program": prog, "control": ctl,
                          "info": json.loads(info[-1][5:]) if info else None}),
              flush=True)
    print(json.dumps({"workload": a.workload, "program_max": lo,
                      "control_min": hi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
