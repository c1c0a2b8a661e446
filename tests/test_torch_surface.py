"""The streaming surface the port carries beside the reference's, held
against ``repro`` on the CPU:

  * ``DynamicHybridIndex.main`` / ``.tomb`` — the sole frozen segment
    and its tombstones, else None, as in ``repro.streaming.index``;
  * ``streaming.build_main`` — Algorithm 1 on an exact row block, its
    bucket ids and CSR tables bit-identical to the reference's;
  * the pre-stack restore: a state with one ``"main"`` subtree and no
    segment meta loads as one frozen segment (the reference's
    ``tests/test_streaming.py`` case, ported), and a legacy state made
    from ``repro``'s ``state_dict`` loads into both packages with equal
    sets on every route;
  * ``kernels.hamming`` — K8's wrapper under the reference's module
    name, with its launch counter, and no alias left in ``distances``.

Families use radius 1 for the p-stable metrics (a power-of-two w), so
the reference's jitted ``/ w`` and the port's division agree exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.core.lsh import make_family as jmake_family  # noqa: E402
from repro.core.lsh.families import bucket_fn_for as jbucket_fn  # noqa: E402
from repro.streaming import CompactionPolicy as JPolicy  # noqa: E402
from repro.streaming import DynamicHybridIndex as JDyn  # noqa: E402
from repro.streaming import build_main as jbuild_main  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core.index import as_rows  # noqa: E402
from repro_torch.core.lsh import make_family  # noqa: E402
from repro_torch.core.lsh.families import bucket_fn_for  # noqa: E402
from repro_torch.data import clustered_dataset, paper_dataset  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import distances, hamming, ops  # noqa: E402
from repro_torch.streaming import (CompactionPolicy,  # noqa: E402
                                   DynamicHybridIndex, build_main)

L, B, M, CAP, DCAP = 4, 128, 32, 2048, 128
RADII = {"l2": 0.45, "cosine": 0.05, "l1": 2.5, "hamming": 16.0}
METRICS = ["l2", "l1", "cosine", "hamming"]
NO_AUTO = dict(delta_fill=2.0, tombstone_ratio=2.0)


def _data(metric, n=600):
    if metric == "hamming":
        return paper_dataset("mnist", scale=0.02, seed=0)[0][:n]
    return clustered_dataset(n, 16, n_clusters=10, dense_core_frac=0.25,
                             core_scale=0.02, seed=0, metric=metric)


def _fam_args(metric):
    d = 64 if metric == "hamming" else 16
    return dict(d=d, L=L, r=1.0 if metric in ("l2", "l1") else RADII[metric])


def _pair(metric, **policy):
    """A reference index and a port index sharing its params."""
    policy = policy or NO_AUTO
    ref = JDyn(jmake_family(metric, **_fam_args(metric)), num_buckets=B, m=M,
               cap=CAP, delta_capacity=DCAP, key=0,
               cost_model=jcore.CostModel(alpha=1.0, beta=1.0),
               policy=JPolicy(**policy))
    port = _port(metric, ref.params, **policy)
    return ref, port


def _port(metric, params, **policy):
    return DynamicHybridIndex(
        make_family(metric, **_fam_args(metric)), num_buckets=B, m=M,
        cap=CAP, delta_capacity=DCAP,
        cost_model=tcore.CostModel(alpha=1.0, beta=1.0),
        policy=CompactionPolicy(**(policy or NO_AUTO)),
        params=params_from_numpy({k: np.asarray(v)
                                  for k, v in params.items()}, "cpu"),
        device="cpu")


def _sets(idx, q, r, force, jax_side=False):
    q = jnp.asarray(q) if jax_side else q
    return idx.query(q, r, force=force).neighbor_sets()


@pytest.mark.parametrize("metric", ["l2", "hamming"])
def test_main_and_tomb_match_reference(metric):
    """None on an empty stack and on several segments; the sole
    segment's rows and tombstones otherwise, equal to the reference's."""
    x = _data(metric)
    ref, port = _pair(metric)
    assert port.main is None and port.tomb is None
    ref.build(jnp.asarray(x[:300]))
    port.build(x[:300])
    ref.delete(list(range(0, 300, 7)))
    port.delete(list(range(0, 300, 7)))
    for name in ("ids", "bucket_ids"):
        np.testing.assert_array_equal(getattr(port.main, name).numpy(),
                                      np.asarray(getattr(ref.main, name)))
    np.testing.assert_array_equal(port.tomb.live.numpy(),
                                  np.asarray(ref.tomb.live))
    np.testing.assert_array_equal(port.tomb.counts.numpy(),
                                  np.asarray(ref.tomb.counts))
    assert port.main.n == ref.main.n
    ref.insert(jnp.asarray(x[300:300 + DCAP + 10]))    # a freeze: 2 segments
    port.insert(x[300:300 + DCAP + 10])
    assert len(port.stack.segments) == 2
    assert port.main is None and port.tomb is None and ref.main is None


@pytest.mark.parametrize("metric", METRICS)
def test_build_main_bit_identical_to_reference(metric):
    """Bucket ids, CSR perm / starts and HLL registers equal the
    reference's on the same rows and params, across hash chunks."""
    x = _data(metric, n=300)
    ids = np.arange(1000, 1300, dtype=np.int64)
    jfam = jmake_family(metric, **_fam_args(metric))
    ref = JDyn(jfam, num_buckets=B, m=M, key=0)
    want = jbuild_main(jnp.asarray(x), jnp.asarray(ids), jbucket_fn(jfam, B),
                       ref.params, B, M, chunk=128)
    fam = make_family(metric, **_fam_args(metric))
    params = params_from_numpy({k: np.asarray(v)
                                for k, v in ref.params.items()}, "cpu")
    got = build_main(as_rows(x, metric, "cpu"), ids, bucket_fn_for(fam, B),
                     params, B, M, chunk=128)
    assert got.n == want.n == 300
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.bucket_ids.numpy(),
                                  np.asarray(want.bucket_ids))
    for name in ("perm", "starts", "registers"):
        np.testing.assert_array_equal(getattr(got.tables, name).numpy(),
                                      np.asarray(getattr(want.tables, name)),
                                      err_msg=name)
    assert got.bucket_ids.dtype == torch.int32


def _legacy(state):
    """The pre-stack layout of a one-segment ``state_dict``: the segment
    as ``"main"`` without its meta, no ``next_uid``."""
    seg = dict(state["segments"]["0000"])
    seg.pop("meta")
    return {"params": state["params"], "main": seg, "delta": state["delta"],
            "meta": {"next_id": state["meta"]["next_id"],
                     "delta_d": state["meta"]["delta_d"]}}


def test_load_state_dict_migrates_pre_stack_checkpoint():
    """A pre-level-stack state (one 'main' subtree, no segment meta)
    restores as a single frozen segment instead of silently dropping
    the corpus (``tests/test_streaming.py``'s case, on the port)."""
    x = _data("l2", n=400)
    q = x[::40][:8]
    r = RADII["l2"]
    _, dyn = _pair("l2")
    dyn.build(x[:350])
    dyn.delete(range(40, 90))
    mig = DynamicHybridIndex(dyn.family, num_buckets=B, m=M, cap=CAP,
                             delta_capacity=DCAP, policy=dyn.policy,
                             cost_model=dyn.cost_model,
                             device="cpu").load_state_dict(
                                 _legacy(dyn.state_dict()))
    assert mig.n == dyn.n and mig.index_stats()["segments"] == 1
    f = mig.stack.segments[0]
    assert (f.uid, f.n_rows, f.n_live) == (0, 512, 300)
    assert f.level == dyn.policy.level_for(512, DCAP)
    for force in ("lsh", "linear"):
        assert _sets(mig, q, r, force) == _sets(dyn, q, r, force), force
    # keeps streaming: the migrated segment is deletable/insertable
    assert mig.delete([100]) == 1
    assert mig.insert(x[350:354]).min() >= 350


@pytest.mark.parametrize("metric", ["l2", "hamming"])
def test_reference_legacy_state_loads_into_both_packages(metric):
    """A legacy state made from ``repro``'s ``state_dict`` (a delta
    holding rows too) loads into both packages with equal sets on every
    route, and equal sizes and live counts."""
    x = _data(metric)
    q = x[::50][:12]
    r = RADII[metric]
    ref, _ = _pair(metric)
    ref.build(jnp.asarray(x[:400]))
    ref.insert(jnp.asarray(x[400:460]))
    ref.delete(list(range(0, 400, 9)) + [405, 410])
    legacy = _legacy(ref.state_dict())
    jmig = JDyn(jmake_family(metric, **_fam_args(metric)), num_buckets=B,
                m=M, cap=CAP, delta_capacity=DCAP, key=0,
                cost_model=jcore.CostModel(alpha=1.0, beta=1.0),
                policy=JPolicy(**NO_AUTO)).load_state_dict(legacy)
    tmig = _port(metric, ref.params).load_state_dict(legacy)
    assert tmig.n == jmig.n == ref.n
    a, b = jmig.index_stats(), tmig.index_stats()
    for k in ("n_live", "n_main", "n_main_dead", "delta_count", "delta_live",
              "segments", "levels"):
        assert a[k] == b[k], k
    assert tmig.state_digests() == jmig.state_digests()
    for force in (None, "lsh", "linear"):
        want = _sets(jmig, q, r, force, jax_side=True)
        assert _sets(tmig, q, r, force) == want, force


def test_hamming_wrapper_lives_in_kernels_hamming():
    """K8's wrapper is ``kernels.hamming.hamming`` with its own launch
    counter; ``distances`` keeps only the two distance matrices; on CPU
    tensors ``ops.hamming_dist`` runs the plain version and the wrapper
    raises without counting a launch."""
    assert not hasattr(distances, "hamming")
    assert hamming.__all__ == ["hamming"]
    before = hamming.hamming.launches
    qc = torch.from_numpy(np.arange(6, dtype=np.int32).reshape(3, 2))
    out = ops.hamming_dist(qc, qc)
    assert out.shape == (3, 3) and int(out.diagonal().sum()) == 0
    with pytest.raises(ValueError, match="CUDA"):
        hamming.hamming(qc, qc)
    assert hamming.hamming.launches == before
