"""Tiny sizes of the cells, for runs on the CPU against the port's plain
path (the same configuration and mix files, scaled down)."""
import contextlib
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

SMALL = {
    "webspam": {"n": 3000, "query_pool": 256, "num_buckets": 1024},
    "covertype": {"n": 4000, "query_pool": 256,
                  "num_buckets": 1024, "delta_capacity": 128,
                  "policy": {"delta_fill": 1.0, "tombstone_ratio": 0.25,
                             "fanout": 4, "step_rows": 128}},
}
SEED = 12345678901


def overrides(cell: str) -> dict:
    return {"config": SMALL.get(cell.split(".")[0], {}),
            "mix": {"batch_queries": 32}}


def run(cell: str, *, seconds: float = 0.3, trace: bool = False,
        control: bool = False, seed: int = SEED, err=None, root=ROOT):
    """One tiny run on the CPU of a cell of ``root``'s benchmark; ``err``
    takes its info, control and check lines (discarded by default)."""
    import io

    import torch

    from bench.lib import harness
    saved = (torch.get_num_threads(), harness.TRACE_ROUNDS,
             harness.WORK_EVERY, harness.WARM_SECONDS)
    torch.set_num_threads(1)        # tests run beside others, many at once
    harness.TRACE_ROUNDS, harness.WORK_EVERY, harness.WARM_SECONDS = 4, 2, 0.0
    try:
        return harness.run_cell(root, cell, seed, seconds, trace, "cpu",
                                overrides=overrides(cell), control=control,
                                err=io.StringIO() if err is None else err)
    finally:
        torch.set_num_threads(saved[0])
        (harness.TRACE_ROUNDS, harness.WORK_EVERY,
         harness.WARM_SECONDS) = saved[1:]


@contextlib.contextmanager
def wrapped(folder: str, attr: str, wrap):
    """Within the block, each module that the harness loads from
    ``bench/<folder>/`` and that has ``attr`` gets ``wrap(attr)`` in its
    place."""
    from bench.lib import harness
    load = harness.load_module

    def spy(path):
        mod = load(path)
        if path.parent.name == folder and hasattr(mod, attr):
            setattr(mod, attr, wrap(getattr(mod, attr)))
        return mod
    harness.load_module = spy
    try:
        yield
    finally:
        harness.load_module = load
