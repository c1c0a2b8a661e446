"""What ``correct`` must refuse: the control (the reference in the
program's place at the precision below the configuration's: TF32
projections and cosine dots, bfloat16 L1 rows) and faults planted in the
timed path of a run whose look for a chip is skipped: a reported row
dropped, every distance 0.1 % long, a segment padded double, every route
flipped."""
import pytest
import torch

from bench.tests import _tiny


@pytest.mark.parametrize("cell", ["webspam.wide", "covertype.read"])
def test_control_fails_a_limit(cell):
    res = _tiny.run(cell, control=True)
    limits = {k: v["limit"] for k, v in res["checks"].items()}
    assert any(res["control"][k] > limits[k] for k in res["control"]), \
        res["control"]


def _drop_nearest(orig):
    """The LSH verification with its nearest reported row taken out."""
    def broken(*a, **k):
        ids, dists, mask = orig(*a, **k)
        mask = mask.clone()
        key = torch.where(mask, dists, torch.full_like(dists, float("inf")))
        flat = int(torch.argmin(key))
        if torch.isfinite(key.reshape(-1)[flat]):
            mask.reshape(-1)[flat] = False
        return ids, dists, mask
    return broken


@pytest.mark.parametrize("cell", ["webspam.wide", "covertype.read"])
def test_altered_answer_is_not_correct(cell, monkeypatch):
    from repro_torch.kernels import ops
    monkeypatch.setattr(ops, "fused_lsh_scan_unsorted",
                        _drop_nearest(ops.fused_lsh_scan_unsorted))
    res = _tiny.run(cell)
    assert not res["correct"]
    assert res["checks"]["report_gap"]["value"] > \
        res["checks"]["report_gap"]["limit"]


def _shift_distances(orig):
    """The LSH verification with every distance it reports 0.1 % too
    long: the same rows, the wrong numbers."""
    def broken(*a, **k):
        ids, dists, mask = orig(*a, **k)
        return ids, dists * 1.001, mask
    return broken


@pytest.mark.parametrize("cell", ["webspam.wide", "covertype.read"])
def test_altered_distance_is_not_correct(cell, monkeypatch):
    from repro_torch.kernels import ops
    monkeypatch.setattr(ops, "fused_lsh_scan_unsorted",
                        _shift_distances(ops.fused_lsh_scan_unsorted))
    res = _tiny.run(cell)
    assert not res["correct"]
    checks = res["checks"]
    assert checks["distance_gap"]["value"] > checks["distance_gap"]["limit"]
    assert checks["report_gap"]["value"] <= checks["report_gap"]["limit"]


def test_segment_padded_otherwise_is_not_correct(monkeypatch):
    from repro_torch.streaming import segment
    orig = segment._pad_size
    monkeypatch.setattr(segment, "_pad_size",
                        lambda k, minimum=8: 2 * orig(k, minimum))
    res = _tiny.run("covertype.read")
    assert not res["correct"]
    assert res["checks"]["state_mismatch"]["value"] > 0


def test_flipped_route_is_not_correct(monkeypatch):
    from repro_torch.core import engine
    orig = engine.finalize_route

    def flipped(*a, **k):
        rt = orig(*a, **k)
        rt.use_lsh = ~rt.use_lsh
        return rt
    monkeypatch.setattr(engine, "finalize_route", flipped)
    res = _tiny.run("webspam.wide")
    assert not res["correct"]
    assert res["checks"]["route_gap"]["value"] > \
        res["checks"]["route_gap"]["limit"]
