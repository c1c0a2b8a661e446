"""Tiny sizes of the cells, for runs on the CPU against the port's plain
path (the same configuration and mix files, scaled down).  Each
configuration brings its own: ``bench/tests/tiny/<config>.json``, shaped
``{"config": {...}, "mix": {...}}``, whose keys replace the file's."""
import contextlib
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

SEED = 12345678901


def overrides(cell: str, root=ROOT) -> dict:
    """The tiny size of ``cell``'s configuration, from ``root``.  A
    configuration with no tiny file raises, so that a forgotten file fails
    at once and not by a build at the full size."""
    from bench.lib import harness
    config = harness.cell_spec(root, cell)["cell"]["config"]
    path = Path(root) / "bench" / "tests" / "tiny" / f"{config}.json"
    if not path.is_file():
        raise KeyError(f"no tiny size for {cell!r}: {path} is missing")
    return harness.load_json(path)


def run(cell: str, *, seconds: float = 0.3, trace: bool = False,
        control: bool = False, seed: int = SEED, err=None, root=ROOT):
    """One tiny run on the CPU of a cell of ``root``'s benchmark; ``err``
    takes its info, control and check lines (discarded by default)."""
    import io

    import torch

    from bench.lib import harness
    over = overrides(cell, root)
    saved = (torch.get_num_threads(), harness.TRACE_ROUNDS,
             harness.WORK_EVERY, harness.WARM_SECONDS)
    torch.set_num_threads(1)        # tests run beside others, many at once
    harness.TRACE_ROUNDS, harness.WORK_EVERY, harness.WARM_SECONDS = 4, 2, 0.0
    try:
        return harness.run_cell(root, cell, seed, seconds, trace, "cpu",
                                overrides=over, control=control,
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
