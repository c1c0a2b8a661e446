"""BENCHMARK.json and every file it names, loaded by name."""
import json
import re

import pytest

from bench.tests._tiny import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all((ROOT / p).is_dir() for p in BENCH["paths"])


def test_names_units_and_bounds():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(CELLS) == len(set(CELLS))


def check_cell_files(root, cell):
    """The cell's files load by name from ``root``, and its configuration's
    cut is written down: ``reduced`` as in ``BENCHMARK.json``, each name a
    key of the file with the source's own value in ``published``, and a
    ``deployment`` that says what share of the deployment the cut is."""
    from bench.lib import harness
    bench = harness.load_json(root / "BENCHMARK.json")
    spec = harness.cell_spec(root, cell)
    cfg = spec["config"]
    entry = next(c for c in bench["configs"]
                 if c["name"] == spec["cell"]["config"])
    assert cfg["name"] == entry["name"]
    assert cfg["reduced"] == entry["reduced"]
    published = cfg.get("published", {})
    for key in cfg["reduced"]:
        assert key in cfg, key
        assert key in published, key
        assert published[key] != cfg[key], key
    if cfg["reduced"]:
        dep = cfg.get("deployment")
        assert isinstance(dep, str) and re.search(r"chip|stage", dep), dep
    assert spec["mix"]["batch_queries"] > 0
    names = {m["name"] for m in spec["end_to_end"]}
    assert {"setup_s", "queries_per_s", "batch_p95_ms"} <= names
    assert spec["per_layer"]


def check_limits_returned(root, cell):
    """Every limit is compared, and every number the check returns for
    comparison has a limit: the names are the same set."""
    from bench.lib import harness
    from bench.tests import _tiny
    returned = []

    def spy(check):
        def checking(*a, **k):
            out = check(*a, **k)
            returned.append(set(out["compared"]))
            return out
        return checking
    with _tiny.wrapped("systems", "check", spy):
        _tiny.run(cell, seconds=0, root=root)
    assert returned == [set(harness.cell_spec(root, cell)["limits"])]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load_by_name(cell):
    check_cell_files(ROOT, cell)


@pytest.mark.parametrize("cell", CELLS)
def test_limits_name_what_the_check_returns(cell):
    check_limits_returned(ROOT, cell)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_loads_and_reads_nothing_from_nothing(metric):
    from bench.lib import harness
    mod = harness.load_module(ROOT / "bench" / "metrics" / f"{metric}.py")
    assert mod.read({}) is None
