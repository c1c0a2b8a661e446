"""Work counts and trace reduction on hand-worked shapes."""
import pytest
import torch

from bench.tests import _tiny  # noqa: F401  (puts the repo on sys.path)
from bench.lib import trace as tr
from bench.reference import judge, lsh

CFG = {"metric": "l1", "cap": 2, "m": 4, "alpha": 1.0, "beta": 10.0,
       "num_buckets": 8}
# rows 0..4 at 0..4 on a line; (table 0, table 1) buckets below
BUCKETS = torch.tensor([[1, 5], [1, 6], [1, 5], [2, 6], [1, 7]])
QB = torch.tensor([[1, 6], [2, 5]])
QV = torch.tensor([[0.5], [2.2]])


def _hashes(b):
    return lsh.Hashes(b, torch.zeros_like(b, dtype=torch.int8), b.clone())


def _state():
    rows = torch.arange(5, dtype=torch.float32)[:, None]
    seg = judge.Segment(ext=torch.arange(5), sketch=True)
    return judge.RefState([seg], rows, _hashes(BUCKETS), CFG, 5)


def _all_live(ext):
    return torch.ones_like(ext, dtype=torch.bool)


def test_lsh_work_counts():
    # q0: table 0 bucket 1 holds rows 0,1,2,4 -> cap 2 admits 0,1; table 1
    # bucket 6 rows 1,3 -> {0,1,3}; q1: {3} | {0,2} -> {0,2,3}
    w = judge.batch_work(_state(), QV, _hashes(QB), _all_live, 1.0,
                         torch.tensor([True, True]))
    assert w["lsh_cands"] == 6 and w["lsh_rows_union"] == 4
    assert w["bucket_entries"] == 4 + 3 and w["probed_buckets"] == 4
    assert w["lsh_pairs"] == 2 + 2            # {0,1} and {2,3} within 1.0
    assert w["q_linear"] == 0 and w["linear_rows"] == 0
    from bench.lib import harness
    mod = harness.load_module(_tiny.ROOT / "bench/metrics/lsh_scan_roofline.py")
    ctx = {"work": w, "work_device_s": {
        "void lsh_scan_kernel<1, 4>(LshArgs)": 1e-6, "other": 5.0}}
    least = max(2 * 1 * 6 / 67e12, (4 * (4 + 7 + 2) + 8 * 4) / 3.35e12)
    assert mod.read(ctx) == pytest.approx(100 * least / 1e-6)


def test_linear_work_counts():
    w = judge.batch_work(_state(), QV, _hashes(QB), _all_live, 1.0,
                         torch.tensor([False, True]))
    assert w["q_linear"] == 1 and w["linear_rows"] == 5
    assert w["linear_qrows"] == 5 and w["linear_pairs"] == 2
    from bench.lib import harness
    mod = harness.load_module(
        _tiny.ROOT / "bench/metrics/linear_dot_roofline.py")
    ctx = {"work": w, "work_device_s": {"dot_tile_kernel": 2e-6}}
    least = max(2 * 5 * 1 / (495e12 / 3), (4 * (5 + 1) + 8 * 2) / 3.35e12)
    assert mod.read(ctx) == pytest.approx(100 * least / 2e-6)


def test_judge_holds_the_due_set():
    st = _state()
    due = judge.Answer(torch.tensor([True, True]), torch.tensor([6, 3]),
                       torch.tensor([3.0, 3.0]), torch.tensor([0, 0, 1, 1]),
                       torch.tensor([0, 1, 2, 3]),
                       torch.tensor([0.5, 0.5, 0.2, 0.8]))
    got = judge.judge(st, QV, _hashes(QB), _all_live, 1.0, due)
    assert got["report_gap"] == 0.0 and got["collision_excess"] == 0.0
    assert got["distance_gap"] == pytest.approx(0.0, abs=1e-6)
    missing = judge.Answer(due.use_lsh, due.collisions, due.cand,
                           due.pair_q[:3], due.pair_ext[:3],
                           due.pair_dist[:3])
    got = judge.judge(st, QV, _hashes(QB), _all_live, 1.0, missing)
    assert got["report_gap"] == pytest.approx(0.2)   # row 3 at 0.8 of 1.0
    # the right rows, one with a wrong distance: only distance_gap sees it
    wrong = judge.Answer(due.use_lsh, due.collisions, due.cand, due.pair_q,
                         due.pair_ext, torch.tensor([0.5, 0.5, 0.25, 0.8]))
    got = judge.judge(st, QV, _hashes(QB), _all_live, 1.0, wrong)
    assert got["report_gap"] == 0.0
    assert got["distance_gap"] == pytest.approx(0.05)


def test_trace_reduce():
    E = tr.Event
    ev = [E("bench.query", False, 0, 100, 1), E("bench.call", False, 0, 80, 1),
          E("cudaStreamSynchronize", False, 50, 60, 1),
          E("aten::mm", False, 10, 20, 1),
          E("k1", True, 10, 30), E("k2", True, 25, 40),
          E("bench.call", True, 0, 80),     # the range's device copy
          E("Memcpy DtoH (Device -> Pageable)", True, 55, 57),
          E("bench.query", False, 100, 200, 1),
          E("bench.call", False, 100, 180, 1), E("k1", True, 150, 160)]
    s = tr.reduce(ev)
    assert s["busy_s"] == pytest.approx(42e-6)
    assert s["window_s"] == pytest.approx(200e-6)
    assert (s["batches"], s["launches"], s["syncs"]) == (2, 3, 1)
    assert sum(v for _, v in s["breakdown"]["idle_gaps"]) == \
        pytest.approx(158e-6)
    assert s["breakdown"]["device_ops"][0][0] == "k1"
    assert s["round_device_s"] == [{"k1": pytest.approx(20e-6),
                                    "k2": pytest.approx(15e-6)},
                                   {"k1": pytest.approx(10e-6)}]



def test_hll_interval_holds_both_estimators_near_the_switch():
    # 10 empty registers and 54 at rank 3: raw = 0.709 * 64^2 / 16.75,
    # 173.4, within 10 % of the switch at 2.5 m = 160, where linear
    # counting (64 ln 6.4 = 118.8) gives the other reading
    regs = torch.tensor([[0] * 10 + [3] * 54])
    raw = 0.709 * 64 * 64 / (10 + 54 / 8)
    small = 64 * torch.log(torch.tensor(6.4, dtype=torch.float64))
    lo, hi = lsh.hll_interval(regs, regs, eps=0.1)
    assert float(lo) == pytest.approx(float(small))
    assert float(hi) == pytest.approx(raw)
    lo, hi = lsh.hll_interval(regs, regs)          # far from it: one branch
    assert float(lo) == pytest.approx(raw) == float(hi)
