"""Parity of ``repro_torch``'s row-sharded indexes with ``repro``'s on the
CPU.

The reference's multi-device half runs once, in a subprocess with four
host devices (``XLA_FLAGS=--xla_force_host_platform_device_count=4``, as
``tests/test_sharded_streaming.py`` runs it), and writes numpy arrays;
the port's half runs here on a CPU ``ShardMesh``.  Every draw is the
reference's (family params through ``interop.params_from_numpy``).

  * static (``core.distributed``, the setup of
    ``tests/test_distributed.py`` at S = 4): per-shard ``perm``,
    ``starts`` and ``registers`` bit-identical, ``collisions`` and
    ``used_lsh`` equal, ``cand_est`` at rtol 1e-6, reported sets equal,
    under both policies;
  * streaming before any merge (``tests/test_sharded_streaming.py``'s
    ``_COMMON`` at S = 2: build 600, insert 200, delete 100, insert 100
    pinned to shard 0 through a freeze, delete again): every
    ``state_dict`` leaf and ``state_digests`` bit-identical; per route
    and routing, sets, ``used_lsh``, ``collisions`` and ``cand_est``;
  * through merges: the scenarios of the seven reference tests that fail
    on jax 0.9 (``compact`` host-indexes a sharded leaf), each held to the
    reference's single-host ``DynamicHybridIndex`` built fresh on the
    survivors, per forced route, with hybrid sets between them;
  * across packages: the reference's sharded checkpoint restores into
    the port at S = 2 and, elastically, S = 4; the port's into the
    reference at S = 2;
  * ``ops.route_terms``' plain version against the reference's
    ``estimate_terms`` + ``merge_registers`` per segment (churned,
    multi-probe); ``RetrievalService`` on a 2-shard mesh against the
    port's and the reference's single-host services; a one-shard mesh
    against the single-host indexes.

The p-stable families use a power-of-two w (radius 1, or 0.5 for the
static l2 setup), so the reference's jitted ``/ w`` and the port's
division agree and bucket ids can be held bit-equal.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced_config  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import hll as jhll  # noqa: E402
from repro.core.lsh import make_family as jmake_family  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.models.parallel import ParallelConfig as JPar  # noqa: E402
from repro.serve import RetrievalConfig as JRConfig  # noqa: E402
from repro.serve import RetrievalService as JService  # noqa: E402
from repro.streaming import CompactionPolicy as JPolicy  # noqa: E402
from repro.streaming import DynamicHybridIndex as JDyn  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.core import CostModel, HybridLSHIndex  # noqa: E402
from repro_torch.core.distributed import (ShardMesh, build_sharded,  # noqa: E402
                                          make_mesh, make_query_fn)
from repro_torch.core.engine import TableSegment  # noqa: E402
from repro_torch.core.lsh import make_family  # noqa: E402
from repro_torch.data import clustered_dataset, query_split  # noqa: E402
from repro_torch.interop import (dynamic_index_from_state,  # noqa: E402
                                 model_params_from_numpy, params_from_numpy,
                                 sharded_index_from_state)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import ParallelConfig  # noqa: E402
from repro_torch.serve import RetrievalConfig, RetrievalService  # noqa: E402
from repro_torch.streaming import (CompactionDriver,  # noqa: E402
                                   CompactionPolicy, DynamicHybridIndex,
                                   ShardedDynamicHybridIndex)

_SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CPU = torch.device("cpu")
REL = 2e-6     # cand_est: the reference's CPU exp2 is inexact for args >= 13

# the static setup of tests/test_distributed.py
SN, SD, SR, SL, SB, SM, SCAP, SOUT = 4096, 16, 0.5, 40, 512, 32, 256, 512
# the streaming setup of tests/test_sharded_streaming.py
D, L, B, M, CAP, R = 8, 4, 256, 32, 2048, 1.2
NO_AUTO = dict(delta_fill=2.0, tombstone_ratio=2.0)
LSM = dict(delta_fill=1.0, tombstone_ratio=2.0, fanout=2, step_rows=64)


def _static_data():
    x = clustered_dataset(SN + 64, SD, n_clusters=8, dense_core_frac=0.2,
                          seed=0)
    x, q = query_split(x, 64, seed=0)
    return np.ascontiguousarray(x[:SN]), np.ascontiguousarray(q)


def _stream_data():
    x = np.asarray(clustered_dataset(900, D, n_clusters=12,
                                     dense_core_frac=0.2, core_scale=0.05,
                                     seed=0, metric="l2"), np.float32)
    return x, x[::60][:12]


def _draws(metric, **kw):
    """(reference family, port family, the reference's key-0 draws as
    port tensors)."""
    jfam = jmake_family(metric, **kw)
    draws = params_from_numpy({k: np.asarray(v) for k, v in
                               jfam.init(jax.random.PRNGKey(0)).items()}, CPU)
    return jfam, make_family(metric, **kw), draws


def _before_merges(idx, x):
    """The pre-merge op stream: build, insert, delete, a pinned insert
    that fills shard 0's delta (a freeze), delete again."""
    idx.build(x[:600])
    idx.insert(x[600:800])
    idx.delete(range(50, 150))
    idx.insert(x[800:900], shard=0)
    idx.delete(list(range(200, 260)) + list(range(820, 860)))
    return idx


_REF_SCRIPT = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.checkpoint import CheckpointManager
from repro.core import CostModel
from repro.core.distributed import build_sharded, make_query_fn
from repro.core.lsh import make_family
from repro.data import clustered_dataset, query_split
from repro.streaming import CompactionPolicy, ShardedDynamicHybridIndex

out_path, ref_ckpt, port_ckpt = sys.argv[1:4]
devs = jax.devices()
assert len(devs) == 4
mesh4 = Mesh(np.array(devs), ("data",))
mesh2 = Mesh(np.array(devs[:2]), ("data",))
res = {}
n, d, r = 4096, 16, 0.5
x = clustered_dataset(n + 64, d, n_clusters=8, dense_core_frac=0.2, seed=0)
x, q = query_split(x, 64, seed=0)
x = x[:n]
fam = make_family("l2", d=d, L=40, r=r)
params = fam.init(jax.random.PRNGKey(0))
state = build_sharded(fam, params, jnp.asarray(x), num_buckets=512, m=32,
                      mesh=mesh4)
for k in ("perm", "starts", "registers"):
    res[f"static/{k}"] = np.asarray(getattr(state, k))
for policy in ("global", "per_shard"):
    qfn = make_query_fn(fam, num_buckets=512, mesh=mesh4, n_total=n,
                        cost_model=CostModel(1.0, 10.0), metric="l2",
                        cap=256, max_out=512, policy=policy)
    for k, v in qfn(state, params, jnp.asarray(q), r).items():
        res[f"static/{policy}/{k}"] = np.asarray(v)

D, L, B, M, CAP, R = 8, 4, 256, 32, 2048, 1.2
fam = make_family("l2", d=D, L=L, r=1.0)
x = np.asarray(clustered_dataset(900, D, n_clusters=12, dense_core_frac=0.2,
                                 core_scale=0.05, seed=0, metric="l2"),
               np.float32)
q = x[::60][:12]

def make(routing):
    return ShardedDynamicHybridIndex(
        fam, num_buckets=B, mesh=mesh2, m=M, cap=CAP, delta_capacity=128,
        policy=CompactionPolicy(delta_fill=2.0, tombstone_ratio=2.0),
        routing=routing, max_out=900, key=0)

for routing in ("global", "per_shard"):
    sh = make(routing)
    sh.build(x[:600])
    sh.insert(x[600:800])
    sh.delete(range(50, 150))
    sh.insert(x[800:900], shard=0)
    sh.delete(list(range(200, 260)) + list(range(820, 860)))
    for force in (None, "lsh", "linear"):
        o = sh.query(q, R, force=force)
        for k in ("ids", "dists", "mask", "collisions", "cand_est",
                  "used_lsh"):
            res[f"stream/{routing}/{force}/{k}"] = np.asarray(getattr(o, k))

def flat(tree, prefix):
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat(v, f"{prefix}/{k}")
    else:
        res[prefix] = np.asarray(tree)

flat(sh.state_dict(), "state")
CheckpointManager(ref_ckpt).save_index(1, sh)
try:
    back = make("per_shard")
    assert CheckpointManager(port_ckpt).restore_index(back) == 1
    for force in ("lsh", "linear"):
        o = back.query(q, R, force=force)
        res[f"from_port/{force}/ids"] = np.asarray(o.ids)
        res[f"from_port/{force}/mask"] = np.asarray(o.mask)
    note = "ok"
except Exception as e:
    note = f"{type(e).__name__}: {e}"
np.savez(out_path, **res)
print("RESULT " + json.dumps({"digests": sh.state_digests(), "from_port": note}))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's sharded runs (one subprocess) and the port's
    pre-merge index at S = 2, whose checkpoint the reference loads."""
    tmp = tmp_path_factory.mktemp("sharded")
    jfam, fam, draws = _draws("l2", d=D, L=L, r=1.0)
    x, _ = _stream_data()
    port = _before_merges(ShardedDynamicHybridIndex(
        fam, num_buckets=B, mesh=make_mesh(2, device="cpu"), m=M, cap=CAP,
        delta_capacity=128, policy=CompactionPolicy(**NO_AUTO),
        routing="per_shard", max_out=900, params=draws), x)
    CheckpointManager(str(tmp / "port")).save_index(1, port)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = _SRC
    out = subprocess.run(
        [sys.executable, "-c", _REF_SCRIPT, str(tmp / "ref.npz"),
         str(tmp / "ref_ckpt"), str(tmp / "port")], env=env,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nERR:\n{out.stderr}"
    line = [l for l in out.stdout.splitlines() if l.startswith("RESULT ")][-1]
    info = json.loads(line[len("RESULT "):])
    with np.load(tmp / "ref.npz") as z:
        arrays = {k: z[k] for k in z.files}
    return dict(arrays=arrays, port=port, ckpt=str(tmp / "ref_ckpt"), **info)


def _union_sets(ids, mask):
    """(S, Q, K) buffers -> {query: set of reported ids}."""
    return {i: set(ids[:, i][mask[:, i]].tolist())
            for i in range(ids.shape[1])}


# --------------------------------------------------------------------------
# the mesh
# --------------------------------------------------------------------------
def test_shard_mesh_reductions_and_placement():
    mesh = make_mesh(3, device="cpu")
    assert mesh.shape == {"data": 3} and mesh.devices == (CPU,) * 3
    t = [torch.tensor([1, 5], dtype=torch.int32),
         torch.tensor([4, 2], dtype=torch.int32),
         torch.tensor([0, 7], dtype=torch.int32)]
    for got in mesh.psum(t):
        assert torch.equal(got, torch.tensor([5, 14], dtype=torch.int32))
    for got in mesh.pmax(t):
        assert torch.equal(got, torch.tensor([4, 7], dtype=torch.int32))
    with pytest.raises(ValueError):
        mesh.psum(t[:2])
    assert ShardMesh(["cpu"], axis="rows").shape == {"rows": 1}


# --------------------------------------------------------------------------
# static sharded index (core.distributed)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("policy", ["global", "per_shard"])
def test_static_sharded_matches_reference(ref, policy):
    a = ref["arrays"]
    _, fam, draws = _draws("l2", d=SD, L=SL, r=SR)
    x, q = _static_data()
    mesh = make_mesh(4, device="cpu")
    state = build_sharded(fam, draws, x, num_buckets=SB, m=SM, mesh=mesh)
    for k in ("perm", "starts", "registers"):
        for s in range(4):
            np.testing.assert_array_equal(getattr(state, k)[s].numpy(),
                                          a[f"static/{k}"][s], err_msg=k)
    qfn = make_query_fn(fam, num_buckets=SB, mesh=mesh, n_total=SN,
                        cost_model=CostModel(1.0, 10.0), metric="l2",
                        cap=SCAP, max_out=SOUT, policy=policy)
    got = qfn(state, draws, q, SR)
    p = f"static/{policy}/"
    np.testing.assert_array_equal(got["collisions"].numpy(),
                                  a[p + "collisions"])
    np.testing.assert_array_equal(got["used_lsh"], a[p + "used_lsh"])
    np.testing.assert_allclose(got["cand_est"].numpy(), a[p + "cand_est"],
                               rtol=1e-6)
    assert (_union_sets(got["ids"].numpy(), got["mask"].numpy())
            == _union_sets(a[p + "ids"], a[p + "mask"]))
    # and the single-host index on the same rows and draws
    est = HybridLSHIndex(fam, num_buckets=SB, m=SM, cap=SCAP, params=draws,
                         device="cpu").build(x).estimate(q)
    assert torch.equal(got["collisions"], est.collisions)
    np.testing.assert_allclose(got["cand_est"].numpy(),
                               est.cand_est.numpy(), rtol=1e-6)


# --------------------------------------------------------------------------
# streaming, before any merge
# --------------------------------------------------------------------------
def test_streaming_state_matches_reference(ref):
    a = ref["arrays"]
    sd = ref["port"].state_dict()
    want = {k[len("state/"):]: v for k, v in a.items()
            if k.startswith("state/")}
    got = {}

    def flat(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                flat(v, f"{prefix}{k}/")
        else:
            got[prefix[:-1]] = np.asarray(tree)

    flat(sd, "")
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert ref["port"].state_digests() == ref["digests"]
    st = ref["port"].index_stats()
    assert st["freezes"] == 1 and st["segments"] == 2, st


@pytest.mark.parametrize("routing", ["global", "per_shard"])
@pytest.mark.parametrize("force", [None, "lsh", "linear"])
def test_streaming_queries_match_reference(ref, routing, force):
    a = ref["arrays"]
    _, fam, draws = _draws("l2", d=D, L=L, r=1.0)
    x, q = _stream_data()
    sh = _before_merges(ShardedDynamicHybridIndex(
        fam, num_buckets=B, mesh=make_mesh(2, device="cpu"), m=M, cap=CAP,
        delta_capacity=128, policy=CompactionPolicy(**NO_AUTO),
        routing=routing, max_out=900, params=draws), x)
    res = sh.query(q, R, force=force)
    p = f"stream/{routing}/{force}/"
    np.testing.assert_array_equal(res.used_lsh, a[p + "used_lsh"])
    np.testing.assert_array_equal(res.collisions.numpy(), a[p + "collisions"])
    np.testing.assert_allclose(res.cand_est.numpy(), a[p + "cand_est"],
                               rtol=REL)
    assert res.neighbor_sets() == _union_sets(a[p + "ids"], a[p + "mask"])


# --------------------------------------------------------------------------
# through merges: the seven reference tests' scenarios
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def oracle():
    """live mask -> {force: sets} of the reference's single-host
    ``DynamicHybridIndex`` built fresh on the surviving rows (cached: a
    scenario checks one mask at many states)."""
    jfam = jmake_family("l2", d=D, L=L, r=1.0)
    x, q = _stream_data()
    cache = {}

    def sets(live):
        key = np.asarray(live, bool).tobytes()
        if key not in cache:
            ids = np.nonzero(live)[0]
            f = JDyn(jfam, num_buckets=B, m=M, cap=CAP, key=0,
                     delta_capacity=512, policy=JPolicy(**NO_AUTO))
            f.build(x[live], ids=ids)
            cache[key] = {force: f.query(q, R, force=force).neighbor_sets()
                          for force in ("lsh", "linear")}
        return cache[key]

    return sets


def _churn(idx, x):
    idx.build(x[:600])
    idx.insert(x[600:800])
    idx.delete(range(50, 150))
    idx.compact()
    idx.insert(x[800:])
    assert idx.delete(list(range(200, 260)) + list(range(820, 860))) == 100
    assert idx.delete([50, 10**6]) == 0        # double / unknown: no-ops
    return idx


def _mid_merge(mk, x):
    sh = mk()
    sh.build(x[:256])
    sh.insert(x[256:600])
    sh.delete(range(32, 96))
    assert sh.has_compaction_work
    sh.compact_step(64)
    live = np.zeros(900, bool)
    live[:600] = True
    live[32:96] = False
    return sh, live


def _scenario(name, mk, check, x, tmp_path):
    """Run one reference test's op stream on the port; ``check(sh, live,
    note)`` holds it to the single-host reference at each state."""
    q = x[::60][:12]
    if name.startswith("churn"):
        sh = _churn(mk(routing=name.split("-")[1]), x)
        live = np.ones(900, bool)
        live[50:150] = live[200:260] = live[820:860] = False
        st = sh.index_stats()
        assert st["compactions"] == 1 and st["delta_count"] > 0, st
        assert sh.n == int(live.sum())
        check(sh, live, "churned")
    elif name == "budgeted":
        sh = mk(lsm=True)
        sh.build(x[:256])
        sh.insert(x[256:600])
        st = sh.index_stats()
        assert st["freezes"] >= 2 and st["segments"] >= 2, st
        assert sh.has_compaction_work
        live = np.zeros(900, bool)
        live[:600] = True
        check(sh, live, "pre-step")
        sh.compact_step(64)
        check(sh, live, "mid-stage")
        dead = list(range(0, 500, 5))
        assert sh.delete(dead) == len(dead)
        live[dead] = False
        check(sh, live, "deleted-mid-merge")
        while sh.compact_step(128):
            pass
        check(sh, live, "drained")
        st = sh.index_stats()
        assert st["compactions"] >= 1 and st["compact_steps"] > 0, st
        assert st["merges_per_level"], st
    elif name.startswith("rebalance-"):
        placement = name.split("-")[1]
        sh = mk(lsm=True, placement=placement)
        sh.build(x[:128])
        sh.insert(x[128:500], shard=0)          # the skewed stream
        assert sh.has_compaction_work
        sh.validate_locations()
        live = np.zeros(900, bool)
        live[:500] = True
        check(sh, live, "pre-step")
        sh.compact_step(64)
        sh.validate_locations()
        dead = list(range(0, 450, 7))
        assert sh.delete(dead) == len(dead)
        live[dead] = False
        sh.validate_locations()
        check(sh, live, "deleted-mid-merge")
        steps = 0
        while sh.compact_step(96):
            sh.validate_locations()
            check(sh, live, f"step-{steps}")
            steps += 1
        check(sh, live, "drained")
        st = sh.index_stats()
        assert st["rows_moved"] > 0 and st["placement"] == placement, st
        if placement == "load_balance":
            assert st["shard_skew"] < 1.5, st
    elif name == "checkpoint":
        sh = _churn(mk(), x)
        mgr = CheckpointManager(str(tmp_path))
        mgr.save_index(3, sh)
        back = mk()
        assert mgr.restore_index(back) == 3
        live = np.ones(900, bool)
        live[50:150] = live[200:260] = live[820:860] = False
        check(back, live, "restored")
        a, b = sh.index_stats(), back.index_stats()
        for key in ("n_live", "n_main", "n_main_dead", "delta_count",
                    "delta_live", "live_per_shard", "delta_per_shard"):
            assert a[key] == b[key], key
        new = back.insert(x[:4])
        assert new.min() >= 900 and back.n == sh.n + 4
        assert back.delete(new.tolist()) == 4
    elif name == "checkpoint-rebalanced":
        sh = mk(lsm=True, placement="load_balance")
        sh.build(x[:128])
        sh.insert(x[128:500], shard=0)
        while sh.compact_step(128):
            pass
        st = sh.index_stats()
        assert st["rows_moved"] > 0, st
        mgr = CheckpointManager(str(tmp_path))
        mgr.save_index(7, sh)
        back = mk(lsm=True, placement="keep_local")   # loses to the state
        assert mgr.restore_index(back) == 7
        assert back.placement.name == "load_balance"
        back.validate_locations()
        b = back.index_stats()
        for key in ("n_live", "n_main", "segments", "levels",
                    "live_per_shard", "delta_per_shard", "shard_skew"):
            assert st[key] == b[key], key
        live = np.zeros(900, bool)
        live[:500] = True
        check(back, live, "restored")
        back.insert(x[500:700], shard=0)
        while back.compact_step(128):
            pass
        back.validate_locations()
        assert back.index_stats()["rows_moved"] > 0
        assert back.index_stats()["shard_skew"] < 1.5
        live[500:700] = True
        check(back, live, "streamed")
    elif name == "checkpoint-mid-merge":
        sh, live = _mid_merge(lambda: mk(lsm=True), x)
        mgr = CheckpointManager(str(tmp_path))
        mgr.save_index(5, sh)
        back = mk(lsm=True)
        assert mgr.restore_index(back) == 5
        check(back, live, "restored")
        a, b = sh.index_stats(), back.index_stats()
        for key in ("n_live", "n_main", "n_main_dead", "delta_count",
                    "delta_live", "segments", "levels", "live_per_shard",
                    "delta_per_shard"):
            assert a[key] == b[key], key
        new = back.insert(x[600:620])
        assert new.min() >= 600
        while back.compact_step(512):
            pass
        while sh.compact_step(512):
            pass
        sh.insert(x[600:620], ids=new)
        live[600:620] = True
        check(back, live, "drained")
        check(sh, live, "drained live index")
        # the pre-stack state (one sharded "main", no meta) migrates
        back.compact()
        sd = back.state_dict()
        lv = dict(sd["levels"]["0000"])
        lv.pop("meta")
        mig = mk(lsm=True)
        mig.load_state_dict({"params": sd["params"], "main": lv,
                             "delta": sd["delta"],
                             "meta": {"next_id": sd["meta"]["next_id"],
                                      "built": sd["meta"]["built"]}})
        assert mig.n == back.n and mig.index_stats()["segments"] == 1
        check(mig, live, "migrated")
    elif name == "elastic":
        sh, live = _mid_merge(lambda: mk(lsm=True), x)
        mgr = CheckpointManager(str(tmp_path))
        mgr.save_index(5, sh, incremental=True)
        narrow = mk(lsm=True, shards=1)
        assert mgr.restore_index(narrow) == 5
        assert narrow.n == sh.n == narrow.validate_locations()
        check(narrow, live, "narrow")
        while narrow.compact_step(512):
            pass
        while sh.compact_step(512):
            pass
        check(narrow, live, "narrow drained")
        check(sh, live, "wide drained")
        new = narrow.insert(x[600:620])
        assert new.min() >= 600 and narrow.delete(new.tolist()) == 20
        narrow.validate_locations()
        mgr.save_index(6, narrow, incremental=True)
        wide = mk(lsm=True)
        assert mgr.restore_index(wide) == 6
        assert wide.n == narrow.n == wide.validate_locations()
        check(wide, live, "wide again")
    else:
        raise ValueError(name)
    for force in ("lsh", "linear"):                # results stay on device
        assert sh.query(q, R, force=force).ids.device == CPU


SCENARIOS = ["churn-global", "churn-per_shard", "budgeted",
             "rebalance-round_robin", "rebalance-load_balance", "checkpoint",
             "checkpoint-rebalanced", "checkpoint-mid-merge", "elastic"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_sharded_merges_match_single_host_reference(name, oracle, tmp_path):
    _, fam, draws = _draws("l2", d=D, L=L, r=1.0)
    x, q = _stream_data()

    def mk(routing="per_shard", lsm=False, placement="keep_local",
           shards=2):
        return ShardedDynamicHybridIndex(
            fam, num_buckets=B, mesh=make_mesh(shards, device="cpu"), m=M,
            cap=CAP, delta_capacity=64 if lsm else 256,
            policy=CompactionPolicy(**(LSM if lsm else NO_AUTO)),
            routing=routing, max_out=900, params=draws, placement=placement)

    def check(sh, live, note):
        want = oracle(live)
        got = {f: sh.query(q, R, force=f).neighbor_sets()
               for f in ("lsh", "linear")}
        for f in ("lsh", "linear"):
            assert got[f] == want[f], (name, note, f)
        hybrid = sh.query(q, R).neighbor_sets()
        for i in hybrid:
            assert want["lsh"][i] <= hybrid[i] <= want["linear"][i], (
                name, note, i)
        dead = set(np.nonzero(~live)[0].tolist())
        assert not any(s & dead for s in hybrid.values()), (name, note)

    _scenario(name, mk, check, x, tmp_path)


def test_compaction_driver_drives_the_sharded_index(oracle):
    """The ``CompactionDriver`` worker stages a sharded merge while the
    control thread queries; ``drain`` applies the swap."""
    _, fam, draws = _draws("l2", d=D, L=L, r=1.0)
    x, q = _stream_data()
    sh = ShardedDynamicHybridIndex(
        fam, num_buckets=B, mesh=make_mesh(2, device="cpu"), m=M, cap=CAP,
        delta_capacity=64, policy=CompactionPolicy(**LSM), max_out=900,
        params=draws, placement="load_balance")
    sh.build(x[:128])
    sh.insert(x[128:500], shard=0)
    drv = CompactionDriver(sh, budget_rows=64, poll_s=0.001).start()
    try:
        live = np.zeros(900, bool)
        live[:500] = True
        while sh.has_compaction_work:
            assert (sh.query(q, R, force="linear").neighbor_sets()
                    == oracle(live)["linear"])
            drv.drain()
    finally:
        drv.stop(flush=True)
    assert not drv.stats()["worker_alive"]
    assert sh.index_stats()["rows_moved"] > 0
    sh.validate_locations()
    for f in ("lsh", "linear"):
        assert sh.query(q, R, force=f).neighbor_sets() == oracle(live)[f]


# --------------------------------------------------------------------------
# checkpoints across packages
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shards", [2, 4])
def test_reference_checkpoint_restores_into_port(ref, shards):
    """The reference's sharded checkpoint (S = 2) restores into the port
    at S = 2 and, elastically, at S = 4; the sets are the reference's."""
    a = ref["arrays"]
    _, fam, _ = _draws("l2", d=D, L=L, r=1.0)
    _, q = _stream_data()
    sh = ShardedDynamicHybridIndex(
        fam, num_buckets=B, mesh=make_mesh(shards, device="cpu"), m=M,
        cap=CAP, delta_capacity=128, policy=CompactionPolicy(**NO_AUTO),
        max_out=900)
    assert CheckpointManager(ref["ckpt"]).restore_index(sh) == 1
    assert sh.validate_locations() == sh.n
    for f in ("lsh", "linear"):
        p = f"stream/per_shard/{f}/"
        assert (sh.query(q, R, force=f).neighbor_sets()
                == _union_sets(a[p + "ids"], a[p + "mask"])), f
    if shards == 2:
        # the same state through interop, and as the reference saved it
        state, _ = CheckpointManager(ref["ckpt"]).restore_tree()
        again = sharded_index_from_state(
            fam, state, make_mesh(2, device="cpu"), num_buckets=B, m=M,
            cap=CAP, max_out=900)
        assert again.state_digests() == ref["digests"]


def test_port_checkpoint_restores_into_reference(ref):
    """The port's sharded checkpoint (S = 2) loads into the reference's
    sharded index, whose sets are the port's."""
    assert ref["from_port"] == "ok", ref["from_port"]
    a = ref["arrays"]
    _, q = _stream_data()
    for f in ("lsh", "linear"):
        assert (_union_sets(a[f"from_port/{f}/ids"], a[f"from_port/{f}/mask"])
                == ref["port"].query(q, R, force=f).neighbor_sets()), f


# --------------------------------------------------------------------------
# ops.route_terms against the reference's per-segment terms
# --------------------------------------------------------------------------
@pytest.mark.parametrize("metric,probes", [("l2", 1), ("cosine", 3)])
def test_route_terms_matches_reference_terms(metric, probes):
    """On a churned single-host index (tombstones in frozen segments):
    per segment, ``ops.route_terms``' plain version equals the reference's
    ``TableSegment.estimate_terms`` collisions and dead counts and its
    ``merge_registers`` of the gathered registers, under multi-probe
    too."""
    r = 1.0 if metric == "l2" else 0.05
    jfam = jmake_family(metric, d=16, L=6, r=r)
    x = clustered_dataset(1200, 16, n_clusters=12, dense_core_frac=0.25,
                          core_scale=0.02, seed=0, metric=metric)
    q = np.ascontiguousarray(x[::37][:24])
    j = JDyn(jfam, num_buckets=128, m=32, cap=2048, key=0, delta_capacity=128,
             policy=JPolicy(fanout=16, tombstone_ratio=2.0))
    j.build(x[:600])
    j.insert(x[600:1100])
    j.delete(range(0, 1100, 9))
    fam = make_family(metric, d=16, L=6, r=r)
    t = dynamic_index_from_state(fam, j.state_dict(), "cpu", num_buckets=128,
                                 m=32, cap=2048,
                                 policy=CompactionPolicy(fanout=16,
                                                         tombstone_ratio=2.0))
    qb_t, tidx_t = t._qbuckets(torch.from_numpy(q), probes)
    segs_t = [s for s in t._segments(tidx_t) if isinstance(s, TableSegment)]
    assert len(segs_t) >= 3
    coll, dead, regs = ops.route_terms(qb_t, [s.table_terms() for s in segs_t],
                                       tidx_t)
    qb_j, tidx_j = j._qbuckets(q, probes)
    segs_j = [s for s in j._segments(tidx_j)
              if isinstance(s, jengine.TableSegment)]
    assert len(segs_j) == len(segs_t)
    np.testing.assert_array_equal(qb_t.numpy(), np.asarray(qb_j))
    for k, s in enumerate(segs_j):
        est = s.estimate_terms(qb_j)
        np.testing.assert_array_equal(coll[k].numpy(),
                                      np.asarray(est.collisions))
        np.testing.assert_array_equal(dead[k].numpy(),
                                      np.asarray(est.dead_collisions))
        merged = jhll.merge_registers(est.registers.astype(np.int32), axis=1)
        np.testing.assert_array_equal(regs[k].numpy().astype(np.int32),
                                      np.asarray(merged))
        assert regs[k].dtype == torch.uint8
    assert int(dead.sum()) > 0


# --------------------------------------------------------------------------
# the retrieval service on a mesh
# --------------------------------------------------------------------------
SMALL = dict(radius=0.5, tables=8, num_buckets=256, hll_m=32, cap=64,
             delta_capacity=64, beta_over_alpha=1.0)


@pytest.mark.parametrize("routing", ["global", "per_shard"])
def test_sharded_service_matches_single_host_services(routing):
    """``RetrievalService`` with a 2-shard CPU mesh, on the reference's
    float32 weights and SimHash draws: per forced route, its sets equal
    the port's single-host service's and the reference's; ``stats``
    carries the per-shard view."""
    jc = dataclasses.replace(jreduced_config(jget_config("yi-6b")),
                             dtype="float32")
    tc = dataclasses.replace(reduced_config(get_config("yi-6b")),
                             dtype="float32")
    jp = jinit_params(jc, jax.random.PRNGKey(0))
    tp = model_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 tc, "cpu")
    jpar = JPar(mesh=None, attn_chunk_q=8, attn_chunk_k=8, logits_chunk=8,
                remat="none")
    par = ParallelConfig(mesh=None, attn_chunk_q=8, attn_chunk_k=8,
                         logits_chunk=8, remat="none")
    _, _, draws = _draws("cosine", d=jc.d_model, L=SMALL["tables"],
                         r=SMALL["radius"], delta=0.1)
    jsvc = JService(jc, jpar, jp, JRConfig(**SMALL))
    single = RetrievalService(tc, par, tp, RetrievalConfig(**SMALL),
                              index_params=draws, device="cpu")
    sharded = RetrievalService(
        tc, par, tp, RetrievalConfig(**SMALL, mesh=make_mesh(2, device="cpu"),
                                     shard_routing=routing,
                                     shard_placement="load_balance"),
        index_params=draws, device="cpu")
    rng = np.random.default_rng(3)
    corpus = [{"tokens": rng.integers(0, jc.vocab, (32, 12)).astype(np.int32)}
              for _ in range(4)]
    for svc in (jsvc, single, sharded):
        assert svc.index_corpus(corpus) == 128
        svc.add_documents(corpus[:2])          # past the delta: a freeze
        svc.remove_documents(list(range(0, 192, 5)))
    batch = {"tokens": np.concatenate([corpus[0]["tokens"][:8],
                                       corpus[3]["tokens"][:8]])}
    emb = single.embed(batch)
    rows = single._embed_corpus(corpus).numpy().astype(np.float64)
    qv = emb.numpy().astype(np.float64)
    r = SMALL["radius"]
    for f in ("lsh", "linear"):
        want = single.index.query(emb, r, force=f).neighbor_sets()
        got = sharded.index.query(emb, r, force=f).neighbor_sets()
        jres = jsvc.index.query(np.asarray(emb), r, force=f).neighbor_sets()
        assert got == want, f
        # the reference embeds its corpus itself: rows within 1e-5 of the
        # radius may fall on either side (documents 128-191 repeat 0-63)
        for i in got:
            for j in got[i] ^ jres[i]:
                x = rows[j % 128]
                dist = 1.0 - qv[i] @ x / (np.linalg.norm(qv[i])
                                          * np.linalg.norm(x))
                assert abs(dist - r) <= 1e-5 * max(1.0, r), (f, i, j, dist)
    res, _ = sharded.query(batch)
    assert res.n_queries == 16 and res.used_lsh.shape == (2,)
    st = sharded.stats
    for key in ("live_per_shard", "delta_per_shard", "shard_skew",
                "rows_moved", "placement"):
        assert key in st, key
    assert sum(st["live_per_shard"]) + st["delta_live"] == single.index.n
    assert st["queries"] == 16
    uid = sharded.submit(batch)
    out = sharded.drain_batches(force=True)
    assert out[uid].n_queries == 16


# --------------------------------------------------------------------------
# one shard
# --------------------------------------------------------------------------
def test_one_shard_mesh_matches_single_host():
    """At S = 1 the sharded indexes report the single-host indexes' sets,
    collisions and estimates, and take the route that the single-host
    estimate's summed costs give the batch."""
    _, fam, draws = _draws("l2", d=SD, L=SL, r=SR)
    x, q = _static_data()
    mesh = make_mesh(1, device="cpu")
    cm = CostModel(1.0, 10.0)
    single = HybridLSHIndex(fam, num_buckets=SB, m=SM, cap=SCAP, params=draws,
                            cost_model=cm, device="cpu").build(x)
    est = single.estimate(q)
    got = make_query_fn(fam, num_buckets=SB, mesh=mesh, n_total=SN,
                        cost_model=cm, metric="l2", cap=SCAP,
                        max_out=SN)(build_sharded(
                            fam, draws, x, num_buckets=SB, m=SM, mesh=mesh),
                            draws, q, SR)
    assert torch.equal(got["collisions"], est.collisions)
    assert torch.equal(got["cand_est"], est.cand_est)
    assert got["used_lsh"][0] == bool(est.lsh_cost.sum()
                                      < est.linear_cost * len(q))
    want = single.query(q, SR, force="lsh" if got["used_lsh"][0]
                        else "linear").neighbor_sets()
    assert _union_sets(got["ids"].numpy(), got["mask"].numpy()) == want

    _, fam, draws = _draws("l2", d=D, L=L, r=1.0)
    xs, qs = _stream_data()
    kw = dict(num_buckets=B, m=M, cap=CAP, delta_capacity=128,
              policy=CompactionPolicy(**NO_AUTO), params=draws)
    one = _before_merges(ShardedDynamicHybridIndex(
        fam, mesh=mesh, max_out=900, **kw), xs)
    dyn = DynamicHybridIndex(fam, device="cpu", **kw)
    dyn.build(xs[:600])
    dyn.insert(xs[600:800])
    dyn.delete(range(50, 150))
    dyn.insert(xs[800:900])
    dyn.delete(list(range(200, 260)) + list(range(820, 860)))
    e = dyn.estimate(qs)
    res = one.query(qs, R)
    assert torch.equal(res.collisions, e.collisions)
    np.testing.assert_allclose(res.cand_est.numpy(), e.cand_est.numpy(),
                               rtol=1e-6)
    assert res.used_lsh[0] == bool(e.lsh_cost.sum() < e.linear_cost * len(qs))
    for f in ("lsh", "linear"):
        assert (one.query(qs, R, force=f).neighbor_sets()
                == dyn.query(qs, R, force=f).neighbor_sets()), f
