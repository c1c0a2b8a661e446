"""Roofline terms and the hardware model (NVIDIA H100 SXM5 80GB HBM3).

The hardware constants below are the one source of the device's peaks
in this package: ``chip_smoke.py`` reads ``PEAKS`` for its kernel bounds
and the train phase's share of the bf16 peak, the same numbers as
``PEAK_FLOPS_BF16`` and ``HBM_BW`` here.

Per chip, as in the reference's dry run:

  compute term    = flops_per_chip / peak_flops
  memory term     = bytes_per_chip / hbm_bw
  collective term = wire_bytes_per_chip / link_bw

The port's dry run (``launch.dryrun``) fills them from
``launch.hlo_analysis``'s count of a step on the meta device: FLOPs and
bytes split evenly over the chips, wire bytes per chip from the
``ShardMesh`` collectives (all-reduce moves ~2x its payload ring-wise;
gather/scatter/permute ~1x).  ``collective_bytes`` is the reference's
parser of optimized HLO text, kept as it is: the port produces no HLO.
``model_flops``, ``linear_scan_traffic`` and ``lsh_scan_traffic`` are
analytic.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional

# NVIDIA H100 SXM5 80GB HBM3, one card, at its 700 W power limit: the
# NVIDIA H100 Tensor Core GPU data sheet, dense rates (no sparsity).
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, bf16 on the tensor cores
PEAK_FLOPS_TF32 = 495e12        # FLOP/s, TF32 on the tensor cores
PEAK_FLOPS_FP32 = 67e12         # FLOP/s, float32 on the CUDA cores
HBM_BW = 3.35e12                # B/s, HBM3
# One direction of the card's 18 NVLink 4 links (900 GB/s both ways).
NVLINK_BW = 450e9               # B/s
# NVIDIA H100 PCIe 80GB, the same data sheet, for a card that names
# itself PCIe: HBM2e at 2.0 TB/s, fp32 51, TF32 378, bf16 756 TFLOP/s.
PEAKS = {"sxm": (HBM_BW, PEAK_FLOPS_FP32, PEAK_FLOPS_TF32, PEAK_FLOPS_BF16),
         "pcie": (2.0e12, 51e12, 378e12, 756e12)}

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
}

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")
_WIRE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}

# one result tensor:  bf16[16,512,128]{...}
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
# op line:  %name = <shape or tuple> opcode(
_OP_RE = re.compile(
    r"=\s*((?:\([^)]*\))|(?:\w+\[[\d,]*\](?:\{[^}]*\})?))\s*"
    r"(" + "|".join(_COLLECTIVES) + r")(?:-start)?\(")


def _shape_bytes(text: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(text):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_bytes(hlo_text: str) -> Dict[str, float]:
    """Per-collective-type wire bytes (per device) from optimized HLO."""
    out = {c: 0.0 for c in _COLLECTIVES}
    counts = {c: 0 for c in _COLLECTIVES}
    for m in _OP_RE.finditer(hlo_text):
        shape_txt, op = m.group(1), m.group(2)
        out[op] += _shape_bytes(shape_txt) * _WIRE_FACTOR[op]
        counts[op] += 1
    out["_counts"] = counts
    return out


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_chip: float
    bytes_per_chip: float
    wire_bytes_per_chip: float
    model_flops_per_chip: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / HLO_FLOPS: remat/masking/redundancy waste."""
        return self.model_flops_per_chip / max(self.flops_per_chip, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute time / achievable step time: the score."""
        model_t = self.model_flops_per_chip / PEAK_FLOPS_BF16
        return model_t / max(self.bound_s, 1e-30)


def terms_from_cost(cost: Dict[str, float], wire_bytes: float,
                    model_flops_global: float, chips: int) -> RooflineTerms:
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    return RooflineTerms(
        compute_s=flops / PEAK_FLOPS_BF16,
        memory_s=byts / HBM_BW,
        collective_s=wire_bytes / NVLINK_BW,
        flops_per_chip=flops,
        bytes_per_chip=byts,
        wire_bytes_per_chip=wire_bytes,
        model_flops_per_chip=model_flops_global / chips,
    )


def linear_scan_traffic(nq: int, n: int, d: int,
                        dtype_bytes: int = 4) -> Dict[str, float]:
    """Analytic HBM bytes for one linear-route scan, composed vs fused.

    Both variants must read the inputs (q, x) and write the reporting
    buffers (dists f32, mask i8, ids i32).  The composed pipeline
    additionally writes the (Q, N) distance matrix and reads it back
    for the threshold compare — the traffic the fused kernel deletes.
    """
    inputs = (nq * d + n * d) * dtype_bytes
    outputs = nq * n * (4 + 1 + 4)
    intermediate = nq * n * (4 + 4)         # dist write + compare re-read
    return {"fused_bytes": float(inputs + outputs),
            "composed_bytes": float(inputs + outputs + intermediate)}


def lsh_scan_traffic(nq: int, c: int, d: int,
                     dtype_bytes: int = 4) -> Dict[str, float]:
    """Analytic HBM bytes for one LSH-route verification, composed vs
    fused, over (Q, C) candidates of d-dim rows.

    Both variants read the candidate ids (sorted + prev) and the corpus
    rows they reference, and write the (Q, C) dists + mask.  The
    composed pipeline materializes the gathered (Q, C, d) rows — one
    write plus one re-read for the rowwise distance — which is the
    dominant traffic of the route and what the fused kernel deletes.
    """
    ids = nq * c * 4 * 2
    gather_read = nq * c * d * dtype_bytes
    outputs = nq * c * (4 + 1)
    intermediate = nq * c * d * dtype_bytes * 2   # rows write + re-read
    return {"fused_bytes": float(ids + gather_read + outputs),
            "composed_bytes": float(ids + gather_read + outputs
                                    + intermediate)}


def scan_memory_seconds(n_bytes: float) -> float:
    """Memory-roofline seconds for ``n_bytes`` of HBM traffic."""
    return float(n_bytes) / HBM_BW


def model_flops(cfg, shape) -> float:
    """Analytic useful FLOPs per step (global).

    train: 6 * N_active * tokens;  prefill: 2 * N_active * tokens;
    decode: 2 * N_active * global_batch (one token each).
    """
    n = cfg.num_active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch
