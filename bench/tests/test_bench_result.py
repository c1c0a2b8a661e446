"""The last line's schema, the exit without a card, and the import
boundary (no ``jax`` / ``repro`` in a run; no ``repro_torch`` in the
reference)."""
import ast
import io
import json
import subprocess
import sys

import pytest

from bench.tests import _tiny

ROOT = _tiny.ROOT
PINNED = json.loads((ROOT / "bench" / "tests" / "pinned_tiny.json").read_text())
MODES = {"plain": {}, "trace": {"trace": True}, "control": {"control": True}}


@pytest.mark.parametrize("cell", ["webspam.wide", "covertype.read"])
def test_result_line_schema(cell):
    res = _tiny.run(cell)
    assert list(res)[:3] == ["correct", "attempted", "failed"]
    assert list(res)[-1] == "checks"
    assert {"metrics", "device"} <= set(res)
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        res["device"])
    assert set(res["metrics"]) == {"queries_per_s", "batch_p95_ms", "setup_s"}
    json.dumps(res)


def test_traced_line_schema():
    res = _tiny.run("covertype.read", seconds=1.0, trace=True)
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert {"device_ops", "idle_gaps"} <= set(res["breakdown"])
    assert {"misroute_pct", "segments_per_batch"} <= set(res["metrics"])
    assert "queries_per_s" not in res["metrics"]


def test_no_result_without_a_card():
    out = subprocess.run(
        [sys.executable, str(ROOT / "bench" / "run.py"), "--workload",
         "webspam.wide", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=120,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert "correct" not in out.stdout


def test_a_run_loads_no_jax_and_no_reference_package():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from bench.tests import _tiny\n"
        "from bench.lib import harness\n"
        "_tiny.run('covertype.read', trace=True)\n"
        "print(harness.forbidden_modules())\n" % (str(ROOT), str(ROOT / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_import_boundary_by_top_level_name():
    for path in (ROOT / "bench").rglob("*.py"):
        tops = {n.split(".")[0] for n in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "repro"}, path
        if "reference" in path.parts:
            assert "repro_torch" not in tops, path


def non_clock_values(cell: str, mode: str) -> dict:
    """Every value of a tiny run that no clock sets: with no window
    (``seconds=0``: one judged round, after the 8 warm-up rounds) the
    rounds, so the judged and traced batches, follow from the seed alone.
    The per-layer readers' context is taken as the harness hands it."""
    seen = {}

    def spy(read):
        def reading(ctx):
            seen.update(keys=sorted(ctx), checks=ctx["checks"],
                        work=ctx["work"], segments=ctx["segments"])
            return read(ctx)
        return reading

    err = io.StringIO()
    with _tiny.wrapped("metrics", "read", spy):
        res = _tiny.run(cell, seconds=0, err=err, **MODES[mode])
    info = json.loads(next(ln[5:] for ln in err.getvalue().splitlines()
                           if ln.startswith("info ")))
    return {"correct": res["correct"], "attempted": res["attempted"],
            "info": {k: info[k] for k in (
                "batches", "warm_rounds", "radius", "judged_queries",
                "pairs_due", "pairs_reported", "doubtful_queries",
                "misroute_pct", "segments")},
            "checks": {k: [v["value"], v["limit"]]
                       for k, v in res["checks"].items()},
            "control": res.get("control"),
            "metrics": {k: v["value"] for k, v in res["metrics"].items()
                        if k in ("misroute_pct", "segments_per_batch")},
            "ctx": seen or None}


EXACT = ("collision_excess", "state_mismatch")     # counts, not gaps


def as_pinned(vals: dict, pinned: dict) -> dict:
    """``vals`` as the pinned record is held to: to the bit, except each
    float gap that the record reads above 0 (a check's, the control's, or
    its copy in ``ctx["checks"]``), which gives only the side of its limit.
    Such gaps are float32 rounding, set by the CPU's order of summation,
    so they differ from machine to machine; the seed fixes all else."""
    limits = {k: lim for k, (_, lim) in pinned["checks"].items()}

    def side(key, value, was):
        base = max((k for k in limits if key == k or key.startswith(k + "_")),
                   key=len, default=None)
        if base is None or base in EXACT or was == 0:
            return value
        return "under" if value <= limits[base] else "over"

    def group(got, rec):
        return {k: side(k, v, rec.get(k, 0)) for k, v in got.items()}
    out = dict(vals)
    out["checks"] = {k: [side(k, v, pinned["checks"].get(k, [0])[0]), lim]
                     for k, (v, lim) in vals["checks"].items()}
    if vals["control"] and pinned["control"]:
        out["control"] = group(vals["control"], pinned["control"])
    if vals["ctx"] and pinned["ctx"]:
        out["ctx"] = {**vals["ctx"], "checks": group(
            vals["ctx"]["checks"], pinned["ctx"]["checks"])}
    return out


@pytest.mark.parametrize("case", sorted(PINNED))
def test_non_clock_values_are_pinned(case):
    """The values recorded from the harness before it took its
    index-specific parts out into ``bench/systems/_index.py``: counts,
    ids, routes, the radius and the limits to the bit, the gaps by the
    side of their limits."""
    cell, mode = case.split("/")
    got = json.loads(json.dumps(non_clock_values(cell, mode)))
    assert as_pinned(got, PINNED[case]) == as_pinned(PINNED[case],
                                                     PINNED[case])
