"""``repro_torch.checkpoint.CheckpointManager`` on the CPU, against
``repro.checkpoint``.

  * each test of ``tests/test_checkpoint.py``, ported with tensors as
    leaves (the elastic-sharding restore: ``target_shardings`` puts each
    leaf on its ``torch.device``, and a sharded index restored through it
    reports the saved one's sets);
  * the host copy: a save takes its leaves to the host before it
    returns, so a tensor mutated in place afterwards (the streaming
    delta) is saved as it was; a writer's exception reaches ``wait``;
  * across packages, on one on-disk format: an index step saved by
    either package's manager, full and incremental, restores into the
    other with equal ``state_digests()`` and equal sets on every route;
    equal states saved incrementally write the same chunk names; a
    bfloat16 leaf round-trips both ways bit for bit;
  * crash recovery: at each fault point (``leaf`` after 1,
    ``pre_commit``, ``post_commit``, through ``harness.CrashPoint``) a
    new manager on the directory restores an index bit-identical to a
    mirror index that replayed the committed prefix.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

import repro.core as jcore  # noqa: E402
from harness import CrashError, CrashPoint  # noqa: E402
from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.core.lsh import make_family as jmake_family  # noqa: E402
from repro.streaming import CompactionPolicy as JPolicy  # noqa: E402
from repro.streaming import DynamicHybridIndex as JDyn  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.checkpoint import CheckpointManager, array_digest  # noqa: E402
from repro_torch.core.lsh import make_family  # noqa: E402
from repro_torch.data import clustered_dataset, paper_dataset  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.obs.schema import CHECKPOINT_STATS_KEYS  # noqa: E402
from repro_torch.streaming import (CompactionPolicy,  # noqa: E402
                                   DynamicHybridIndex)

L, B, M, CAP, DCAP = 4, 128, 32, 2048, 64
RADII = {"l2": 0.45, "hamming": 16.0}
POLICY = dict(fanout=2, tombstone_ratio=2.0)


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"blocks": ({"w": torch.randn(4, 8, generator=g)},
                              {"w": torch.randn(8, 4, generator=g)}),
                   "tail": ()},
        "opt": {"step": torch.tensor(7, dtype=torch.int32)},
    }


def _restore_cpu(mgr, template, step=None):
    return mgr.restore(template, step=step, device="cpu")


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    s = _state()
    mgr.save(10, s, blocking=True)
    restored, step = _restore_cpu(mgr, s)
    assert step == 10
    w = restored["params"]["blocks"][0]["w"]
    assert isinstance(w, torch.Tensor) and w.device.type == "cpu"
    assert torch.equal(w, s["params"]["blocks"][0]["w"])
    assert isinstance(restored["params"]["blocks"], tuple)
    assert restored["params"]["tail"] == ()
    assert int(restored["opt"]["step"]) == 7
    assert restored["opt"]["step"].dtype == torch.int32
    assert restored["opt"]["step"].shape == ()


def test_uncommitted_checkpoint_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, _state(), blocking=True)
    # simulate a crash mid-save: directory without COMMITTED marker
    d = os.path.join(str(tmp_path), "step_0000000009")
    os.makedirs(d)
    with open(os.path.join(d, "manifest.json"), "w") as f:
        f.write("{}")
    assert mgr.latest_step() == 5


def test_retention_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    s = _state()
    for step in (1, 2, 3, 4):
        mgr.save(step, s, blocking=True)
    assert mgr.committed_steps() == [3, 4]


def test_async_save_then_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state(), blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 1


def test_restore_onto_a_mesh_not_implemented(tmp_path):
    """``target_shardings`` (the counterpart of the reference's
    ``test_elastic_restore_new_sharding``): a matching pytree of
    ``torch.device`` puts each leaf on the device given for it, and a
    row-sharded index's state restored through it loads into an index on
    the mesh with the saved one's sets.  The default device is the GPU,
    and asking for it without one raises."""
    from repro_torch.core.distributed import make_mesh
    from repro_torch.streaming import ShardedDynamicHybridIndex
    mgr = CheckpointManager(str(tmp_path))
    s = _state()
    mgr.save(3, s, blocking=True)
    cpu = torch.device("cpu")
    devs = {"params": {"blocks": ({"w": cpu}, {"w": "cpu"}), "tail": ()},
            "opt": {"step": cpu}}
    restored, step = mgr.restore(s, target_shardings=devs)
    assert step == 3
    leaf = restored["params"]["blocks"][0]["w"]
    assert isinstance(leaf, torch.Tensor) and leaf.device == cpu
    assert torch.equal(leaf, s["params"]["blocks"][0]["w"])
    assert int(restored["opt"]["step"]) == 7

    fam = make_family("l2", d=8, L=L, r=1.0)
    x = clustered_dataset(300, 8, n_clusters=6, seed=0, metric="l2")
    sh = ShardedDynamicHybridIndex(fam, num_buckets=B, m=M, cap=CAP,
                                   mesh=make_mesh(2, device="cpu"),
                                   delta_capacity=DCAP, max_out=300)
    sh.build(x[:200])
    sh.insert(x[200:])
    sh.delete(range(0, 300, 7))
    state = sh.state_dict()
    mgr.save(4, state, blocking=True)
    tree = _map_tree(lambda _: cpu, state)
    got, _ = mgr.restore(state, step=4, target_shardings=tree)
    assert got["levels"]["0000"]["registers"].device == cpu
    back = ShardedDynamicHybridIndex(fam, num_buckets=B, m=M, cap=CAP,
                                     mesh=make_mesh(2, device="cpu"),
                                     delta_capacity=DCAP, max_out=300)
    back.load_state_dict(got)
    q = x[::23]
    for f in ("lsh", "linear"):
        assert (back.query(q, 1.2, force=f).neighbor_sets()
                == sh.query(q, 1.2, force=f).neighbor_sets()), f
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mgr.restore(s, step=3)
    assert _restore_cpu(mgr, s, step=3)[1] == 3


def _map_tree(fn, tree):
    """``fn`` over the leaves of nested dicts / lists / tuples."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return fn(tree)


def _chunk_files(tmp_path):
    d = os.path.join(str(tmp_path), "chunks")
    return sorted(os.listdir(d)) if os.path.isdir(d) else []


def test_incremental_roundtrip_and_chunk_reuse(tmp_path):
    """Identical leaves across steps share one chunk file, only changed
    leaves write bytes, and restore is bit-exact from the chunk store."""
    mgr = CheckpointManager(str(tmp_path))
    s = _state()
    mgr.save_incremental(1, s, blocking=True)
    n1 = len(_chunk_files(tmp_path))
    s2 = dict(s, opt={"step": torch.tensor(8, dtype=torch.int32)})
    mgr.save_incremental(2, s2, blocking=True)
    st = mgr.stats()
    assert st["incremental_saves"] == 2
    assert st["chunks_written"] == n1 + 1         # only the new leaf
    assert st["chunks_reused"] == n1 - 1          # params shared
    assert st["bytes_reused"] > 0
    restored, step = _restore_cpu(mgr, s)
    assert step == 2
    assert torch.equal(restored["params"]["blocks"][0]["w"],
                       s["params"]["blocks"][0]["w"])
    assert int(restored["opt"]["step"]) == 8


def test_incremental_digest_hints_trusted_only_with_chunk(tmp_path):
    """A digest hint whose chunk file is missing is recomputed, not
    trusted — otherwise a stale hint silently drops a leaf."""
    mgr = CheckpointManager(str(tmp_path))
    s = _state()
    mgr.save_incremental(1, s, digests={"opt/step": "0" * 32}, blocking=True)
    restored, step = _restore_cpu(mgr, s)
    assert step == 1 and int(restored["opt"]["step"]) == 7


def test_chunk_gc_follows_retention(tmp_path):
    """Chunks referenced only by GC'd steps are removed; chunks shared
    with kept steps survive."""
    mgr = CheckpointManager(str(tmp_path), keep=1)
    s = _state()
    mgr.save_incremental(1, s, blocking=True)
    s2 = dict(s, opt={"step": torch.tensor(9, dtype=torch.int32)})
    mgr.save_incremental(2, s2, blocking=True)
    assert mgr.committed_steps() == [2]
    assert mgr.stats()["chunks_gced"] >= 1        # step 1's opt leaf
    restored, step = _restore_cpu(mgr, s)
    assert step == 2 and int(restored["opt"]["step"]) == 9


def test_crashed_save_swept_on_restart(tmp_path):
    """A save killed before COMMITTED leaves a torn step; a new manager
    on the directory sweeps it and serves the newest committed step,
    with no .tmp litter anywhere."""
    mgr = CheckpointManager(str(tmp_path))
    s = _state()
    mgr.save_incremental(1, s, blocking=True)
    crash = CrashPoint("pre_commit")
    cmgr = CheckpointManager(str(tmp_path), fault_hook=crash)
    with pytest.raises(CrashError):
        cmgr.save_incremental(2, _state(1), blocking=True)
    assert crash.fired
    mgr2 = CheckpointManager(str(tmp_path))       # restart
    assert mgr2.latest_step() == 1
    assert mgr2.stats()["litter_swept"] >= 1
    for root, _, files in os.walk(str(tmp_path)):
        assert not [f for f in files if f.endswith(".tmp")], root
    restored, step = _restore_cpu(mgr2, s)
    assert step == 1 and int(restored["opt"]["step"]) == 7


def test_crash_mid_leaf_full_save_swept(tmp_path):
    """Dying after the first leaf of a full save leaves an uncommitted
    step dir that the next manager init removes."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state(), blocking=True)
    crash = CrashPoint("leaf", after=1)
    cmgr = CheckpointManager(str(tmp_path), fault_hook=crash)
    with pytest.raises(CrashError):
        cmgr.save(2, _state(1), blocking=True)
    mgr2 = CheckpointManager(str(tmp_path))
    assert mgr2.latest_step() == 1
    assert mgr2.committed_steps() == [1]


def test_writer_error_reaches_wait(tmp_path):
    """A background save that dies hands its exception to ``wait``
    (and only once); nothing is committed."""
    cmgr = CheckpointManager(str(tmp_path), fault_hook=CrashPoint("pre_commit"))
    cmgr.save_incremental(1, _state(), blocking=False)
    with pytest.raises(CrashError):
        cmgr.wait()
    cmgr.wait()
    assert cmgr.latest_step() is None


def test_save_copies_leaves_before_returning(tmp_path):
    """The host copy happens on the caller's thread: a tensor updated in
    place after a non-blocking save returns is saved as it was."""
    mgr = CheckpointManager(str(tmp_path))
    t = torch.arange(1 << 16, dtype=torch.float32)
    mgr.save_incremental(1, {"x": t}, blocking=False)
    t.add_(1.0)
    mgr.save(2, {"x": t}, blocking=False)
    t.zero_()
    mgr.wait()
    one, _ = _restore_cpu(mgr, {"x": None}, step=1)
    two, _ = _restore_cpu(mgr, {"x": None}, step=2)
    assert torch.equal(one["x"], torch.arange(1 << 16, dtype=torch.float32))
    assert torch.equal(two["x"], one["x"] + 1.0)


def test_checkpoint_stats_schema_pinned(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_incremental(1, _state(), blocking=True)
    assert frozenset(mgr.stats()) == CHECKPOINT_STATS_KEYS


def test_array_digest_dtype_and_shape_sensitive():
    """The content address covers dtype and shape, not just bytes, and
    a tensor hashes as its host array."""
    a = np.arange(8, dtype=np.int32)
    assert array_digest(a) == array_digest(a.copy())
    assert array_digest(a) == array_digest(torch.from_numpy(a))
    assert array_digest(a) != array_digest(a.astype(np.float32))
    assert array_digest(a) != array_digest(a.reshape(2, 4))
    b = a.copy()
    b[0] = 99
    assert array_digest(a) != array_digest(b)


# --------------------------------------------------------------------------
# across packages: one on-disk format
# --------------------------------------------------------------------------
def _data(metric, n=700):
    if metric == "hamming":
        return paper_dataset("mnist", scale=0.02, seed=0)[0][:n]
    return clustered_dataset(n, 16, n_clusters=10, dense_core_frac=0.25,
                             core_scale=0.02, seed=0, metric=metric)


def _fam_args(metric):
    d = 64 if metric == "hamming" else 16
    return dict(d=d, L=L, r=1.0 if metric == "l2" else RADII[metric])


def _ref_index(metric):
    return JDyn(jmake_family(metric, **_fam_args(metric)), num_buckets=B,
                m=M, cap=CAP, delta_capacity=DCAP, key=0,
                cost_model=jcore.CostModel(alpha=1.0, beta=1.0),
                policy=JPolicy(**POLICY))


def _port_index(metric, params):
    return DynamicHybridIndex(
        make_family(metric, **_fam_args(metric)), num_buckets=B, m=M,
        cap=CAP, delta_capacity=DCAP,
        cost_model=tcore.CostModel(alpha=1.0, beta=1.0),
        policy=CompactionPolicy(**POLICY),
        params=params_from_numpy({k: np.asarray(v)
                                  for k, v in params.items()}, "cpu"),
        device="cpu")


def _churn(idx, x, jax_side, lo=0, hi=None):
    """A fixed op stream: build, inserts through the delta (freezes, a
    level merge), deletes in frozen segments and in the delta."""
    rows = (lambda a: jnp.asarray(a)) if jax_side else (lambda a: a)
    if lo == 0:
        idx.build(rows(x[:300]))
        idx.insert(rows(x[300:450]))
        idx.delete(list(range(0, 300, 11)) + [305, 440])
    if hi is None or hi > 450:
        idx.insert(rows(x[450:560]))
        idx.delete(list(range(452, 470, 3)) + [2, 13])


def _assert_same_index(a, b, q, r, a_jax=False):
    assert a.state_digests() == b.state_digests()
    sa, sb = a.index_stats(), b.index_stats()
    for k in ("n_live", "n_main", "n_main_dead", "delta_count", "delta_live",
              "segments", "levels"):
        assert sa[k] == sb[k], k
    for force in (None, "lsh", "linear"):
        qa = jnp.asarray(q) if a_jax else q
        assert (a.query(qa, r, force=force).neighbor_sets()
                == b.query(q, r, force=force).neighbor_sets()), force


@pytest.mark.parametrize("incremental", [False, True],
                         ids=["full", "incremental"])
@pytest.mark.parametrize("metric", ["l2", "hamming"])
def test_index_step_crosses_packages_both_ways(tmp_path, metric, incremental):
    """A churned index saved by ``repro``'s manager restores into the
    port, and the port's save restores into ``repro``, with equal
    ``state_digests()``, sizes and sets on every route."""
    x = _data(metric)
    q = x[::60][:12]
    r = RADII[metric]
    ref = _ref_index(metric)
    _churn(ref, x, jax_side=True)
    port = _port_index(metric, ref.params)
    _churn(port, x, jax_side=False)
    assert len(port.stack.segments) >= 2 and port.delta.count > 0
    JManager(str(tmp_path / "ref")).save_index(3, ref,
                                               incremental=incremental)
    CheckpointManager(str(tmp_path / "port")).save_index(
        3, port, incremental=incremental)

    into_port = _port_index(metric, ref.params)
    assert CheckpointManager(str(tmp_path / "ref")).restore_index(
        into_port) == 3
    _assert_same_index(ref, into_port, q, r, a_jax=True)
    into_ref = _ref_index(metric)
    assert JManager(str(tmp_path / "port")).restore_index(into_ref) == 3
    _assert_same_index(into_ref, port, q, r, a_jax=True)


def test_equal_states_write_the_same_chunks(tmp_path):
    """Equal index states saved incrementally by both packages (state
    digests as hints) leave the same chunk file names, and the same
    manifests' leaves; a second step reuses the frozen levels in both."""
    x = _data("hamming")
    ref = _ref_index("hamming")
    port = _port_index("hamming", ref.params)
    jm = JManager(str(tmp_path / "ref"))
    tm = CheckpointManager(str(tmp_path / "port"))
    for step, (lo, hi) in enumerate(((0, 450), (450, None)), start=1):
        _churn(ref, x, True, lo, hi)
        _churn(port, x, False, lo, hi)
        jm.save_index(step, ref, incremental=True)
        tm.save_index(step, port, incremental=True)
        assert (_chunk_files(tmp_path / "ref")
                == _chunk_files(tmp_path / "port"))
        with open(tmp_path / "ref" / f"step_{step:010d}" /
                  "manifest.json") as f:
            jman = f.read()
        with open(tmp_path / "port" / f"step_{step:010d}" /
                  "manifest.json") as f:
            tman = f.read()
        assert jman == tman
    a, b = jm.stats(), tm.stats()
    for k in ("chunks_written", "chunks_reused", "bytes_written",
              "bytes_reused"):
        assert a[k] == b[k], k
    assert b["chunks_reused"] >= 6               # a frozen level's leaves


def test_bfloat16_leaf_round_trips_both_ways(tmp_path):
    """A torch bfloat16 leaf saved by the port restores in ``repro`` as
    the same bits, and a bfloat16 leaf saved by ``repro`` restores in
    the port: a CPU ``torch.bfloat16`` tensor from ``restore_tree``, and
    a tensor on the asked device from ``restore``."""
    g = torch.Generator().manual_seed(3)
    w = torch.randn(5, 7, generator=g).to(torch.bfloat16)
    bits = w.view(torch.int16).numpy().view(np.uint16)
    for incremental in (False, True):
        d = tmp_path / f"port{int(incremental)}"
        tm = CheckpointManager(str(d))
        (tm.save_incremental if incremental else tm.save)(
            1, {"w": w, "n": np.int64(4)}, blocking=True)
        got, _ = JManager(str(d)).restore_tree()
        assert got["w"].dtype == ml_dtypes.bfloat16
        np.testing.assert_array_equal(np.asarray(got["w"]).view(np.uint16),
                                      bits)

        d = tmp_path / f"ref{int(incremental)}"
        jm = JManager(str(d))
        jw = jnp.asarray(bits.view(ml_dtypes.bfloat16))
        (jm.save_incremental if incremental else jm.save)(
            1, {"w": jw, "n": np.int64(4)}, blocking=True)
        tm = CheckpointManager(str(d))
        tree, _ = tm.restore_tree()
        assert tree["w"].dtype == torch.bfloat16
        assert torch.equal(tree["w"].view(torch.int16),
                           w.view(torch.int16))
        assert int(tree["n"]) == 4
        restored, _ = _restore_cpu(tm, {"w": None, "n": None})
        assert restored["w"].dtype == torch.bfloat16
        assert torch.equal(restored["w"].view(torch.int16),
                           w.view(torch.int16))


# --------------------------------------------------------------------------
# crash recovery: bit-identical to the committed prefix
# --------------------------------------------------------------------------
def _state_equal(a, b, path=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _state_equal(a[k], b[k], f"{path}/{k}")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, path
    np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("point,after,committed", [
    ("leaf", 1, 1), ("pre_commit", 0, 1), ("post_commit", 0, 2)])
def test_crash_restores_committed_prefix(tmp_path, point, after, committed):
    """Step 1 commits; step 2 dies at ``point``.  A new manager on the
    directory restores the newest committed step, bit-identical (every
    state leaf, digests, sets per route) to a mirror index that replayed
    the ops that step captured."""
    x = _data("hamming")
    q = x[::60][:12]
    r = RADII["hamming"]
    params = _ref_index("hamming").params
    live = _port_index("hamming", params)
    mgr = CheckpointManager(str(tmp_path))
    _churn(live, x, False, 0, 450)
    mgr.save_index(1, live, incremental=True)
    _churn(live, x, False, 450, None)
    crash = CrashPoint(point, after=after)
    with pytest.raises(CrashError):
        CheckpointManager(str(tmp_path), fault_hook=crash).save_index(
            2, live, incremental=True)
    assert crash.fired

    restart = CheckpointManager(str(tmp_path))
    assert restart.latest_step() == committed
    for root, _, files in os.walk(str(tmp_path)):
        assert not [f for f in files if f.endswith(".tmp")], root
    restored = _port_index("hamming", params)
    assert restart.restore_index(restored) == committed
    mirror = _port_index("hamming", params)
    _churn(mirror, x, False, 0, 450 if committed == 1 else None)
    _state_equal(restored.state_dict(), mirror.state_dict())
    _assert_same_index(mirror, restored, q, r)
