"""Dry run of the production meshes: every (arch x shape x mesh) cell's
step run once on torch's meta device (shapes only, nothing allocated)
under ``hlo_analysis.CostCounter``, recorded as JSON for the roofline
report.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

The records go to ``results/dryrun_torch/`` under the reference's keys.
A cell's mesh is ``launch.mesh.make_production_mesh`` (16 x 16, or
2 x 16 x 16 with a 'pod' axis) of the meta device; its inputs are
``specs.input_specs``' meta trees; its step is the launcher's
(``make_jitted_train_step``, which checks the state and batch against
their specs, ``make_serve_prefill``, ``make_serve_step``).

What the record means, beside the reference's compiled per-device
module: one controller runs the whole step, so the counted FLOPs and
bytes are global (``cost_global``) and ``cost`` is their even split over
the chips (the assumption the reference's ``model_flops_per_chip``
makes); wire bytes are per chip and come from the ``shard_map`` sites
alone (``ShardMesh`` collectives; GSPMD's own collectives have no
counterpart on one controller); ``memory`` holds the exact input bytes a
device holds (``argument_size_in_bytes``, from shard shapes) and the
peak live bytes of the whole single-controller step
(``peak_live_bytes_global``).

A failing cell is a bug: ``--all`` records it with status ``error`` and
exits 1.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Dict, Optional, Sequence

import torch

from repro_torch.configs import (ARCH_NAMES, SHAPES, get_config,
                                 shape_applicable)
from repro_torch.launch import hlo_analysis
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import (input_bytes_per_device, input_specs,
                                      make_par)
from repro_torch.models.parallel import ParallelConfig
from repro_torch.serve.engine import make_serve_prefill, make_serve_step
from repro_torch.train.step import TrainConfig, make_jitted_train_step

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

NOTES = {
    "device": "meta: shapes only, the whole step on one controller",
    "cost": "counted global FLOPs and bytes / chips (an even split)",
    "bytes": "unfused operand + result bytes of each ATen op: an upper "
             "bound on post-fusion traffic",
    "collectives": "shard_map sites (ShardMesh collectives), per chip; "
                   "no GSPMD collectives",
}


def parse_overrides(text: str) -> Dict:
    """``k=v[,k=v]`` over ``ParallelConfig``'s fields (not ``mesh``):
    true / false as bools, digits as ints, else strings."""
    fields = sorted(f.name for f in dataclasses.fields(ParallelConfig)
                    if f.name != "mesh")
    out = {}
    for kv in filter(None, text.split(",")):
        k, v = kv.split("=")
        if k not in fields:
            raise ValueError(f"--override {k!r}: not a ParallelConfig "
                             f"field; the fields are {fields}")
        out[k] = {"true": True, "false": False}.get(
            v.lower(), v if not v.isdigit() else int(v))
    return out


def _step(cfg, shape, par, tcfg):
    if shape.kind == "train":
        return make_jitted_train_step(cfg, par, tcfg)
    if shape.kind == "prefill":
        return make_serve_prefill(cfg, par, cache_len=shape.seq_len)
    return make_serve_step(cfg, par)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             overrides: Optional[dict] = None, tag: str = "", *,
             cfg=None, shape=None, mesh=None) -> Dict:
    """One cell's record.  ``cfg``, ``shape`` (a ``ShapeSpec``) and
    ``mesh`` replace the named config, shape and production mesh (a
    reduced cell on a small meta mesh)."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec: Dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                 "tag": tag, "status": "skipped", "reason": reason}
    if not ok:
        return rec

    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    if mesh.devices[0].type != "meta":
        raise ValueError(f"a dry run is of the meta device, not "
                         f"{mesh.devices[0]}")
    chips = mesh.size
    rec["mesh"] = "x".join(str(n) for n in mesh.shape.values())
    par = make_par(mesh, multi_pod, cfg, shape, **(overrides or {}))
    tcfg = TrainConfig()
    args, in_specs, _ = input_specs(cfg, shape, par, tcfg)
    args_bytes = input_bytes_per_device(args, in_specs, mesh)
    fn = _step(cfg, shape, par, tcfg)

    t0 = time.time()
    if shape.kind == "train":
        costs = hlo_analysis.analyze_step(fn, *args)
    else:
        with torch.inference_mode():
            costs = hlo_analysis.analyze_step(fn, *args)
    run_s = time.time() - t0
    del args

    wire = sum(costs.wire.values())
    mf = rl.model_flops(cfg, shape)
    per_chip = {"flops": costs.flops / chips,
                "bytes accessed": costs.bytes / chips}
    terms = rl.terms_from_cost(per_chip, wire, mf, chips)
    rec.update({
        "status": "ok", "chips": chips, "run_s": round(run_s, 1),
        "memory": {"argument_size_in_bytes": args_bytes,
                   "peak_live_bytes_global": costs.peak_live_bytes},
        "input_bytes_per_device": args_bytes,
        "cost": per_chip,
        "cost_global": {"flops": costs.flops, "bytes accessed": costs.bytes},
        "collectives": dict(costs.wire),
        "collective_counts": dict(costs.coll_counts),
        "bytes_by_op": {k: round(v) for k, v in sorted(
            costs.by_op.items(), key=lambda kv: -kv[1])[:12]},
        "terms": {
            "compute_s": terms.compute_s, "memory_s": terms.memory_s,
            "collective_s": terms.collective_s,
            "dominant": terms.dominant,
            "model_flops_global": mf,
            "useful_flops_ratio": terms.useful_flops_ratio,
            "roofline_fraction": terms.roofline_fraction,
        },
        "params": cfg.num_params(),
        "active_params": cfg.num_active_params(),
        "notes": NOTES,
    })
    return rec


def cell_path(arch: str, shape: str, mesh_name: str, tag: str = "") -> str:
    os.makedirs(RESULTS_DIR, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    return os.path.join(RESULTS_DIR,
                        f"{arch}__{shape}__{mesh_name}{suffix}.json")


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true",
                    help="recompute cached cells")
    ap.add_argument("--tag", default="", help="variant tag (perf iters)")
    ap.add_argument("--override", default="",
                    help="k=v[,k=v] ParallelConfig overrides")
    args = ap.parse_args(argv)
    overrides = parse_overrides(args.override)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    cells = ([(a, s) for a in ARCH_NAMES for s in SHAPES]
             if args.all else [(args.arch, args.shape)])

    failures = 0
    for arch, shape in cells:
        for mp in meshes:
            mesh_name = "2x16x16" if mp else "16x16"
            path = cell_path(arch, shape, mesh_name, args.tag)
            if os.path.exists(path) and not args.force:
                print(f"[cache] {arch} {shape} {mesh_name}")
                continue
            print(f"[run]   {arch} {shape} {mesh_name} ...", flush=True)
            try:
                rec = run_cell(arch, shape, mp, overrides, args.tag)
            except Exception as e:
                traceback.print_exc()
                rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                       "tag": args.tag, "status": "error",
                       "error": f"{type(e).__name__}: {e}"}
                failures += 1
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            if rec["status"] == "ok":
                t = rec["terms"]
                print(f"  ok: run={rec['run_s']}s "
                      f"in/dev={rec['input_bytes_per_device'] / 2**30:.2f}GiB "
                      f"dominant={t['dominant']} "
                      f"roofline={t['roofline_fraction']:.3f}", flush=True)
            elif rec["status"] == "skipped":
                print(f"  skipped: {rec['reason']}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
