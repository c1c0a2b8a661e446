"""The last line's schema, the exit without a card, and the import
boundary (no ``jax`` / ``repro`` in a run; no ``repro_torch`` in the
reference)."""
import ast
import json
import subprocess
import sys

import pytest

from bench.tests import _tiny

ROOT = _tiny.ROOT


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
