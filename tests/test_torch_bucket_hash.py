"""The bucket hash's spec on the CPU (``families.bucket_ids``,
``multiprobe.probe_buckets``; the kernel in ``csrc/bucket_hash.cu`` is held
to the same spec on the card in ``test_torch_gpu.py``).

The plain path, which CPU, meta and ``impl="ref"`` tensors take, is held
bit for bit to an independent numpy uint32 version (``torch_cases.
np_bucket_ids``) on SimHash across word edges, p-stable L1 / L2 on exact
multiples of w, negative floors and floors past 2^31, bit sampling and
multi-probe codes.  The index wiring of the kernel path (the family's front
end, the counter, no divisor copy) runs here with the kernel stood in by
the numpy version."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import CostModel, HybridLSHIndex  # noqa: E402
from repro_torch.core import multiprobe as mp  # noqa: E402
from repro_torch.core.lsh import families as F  # noqa: E402
from repro_torch.core.lsh import make_family  # noqa: E402
from repro_torch.data import clustered_dataset, query_split  # noqa: E402
from repro_torch.kernels import bucket_hash as bh  # noqa: E402
from repro_torch.streaming import CompactionPolicy, DynamicHybridIndex  # noqa: E402
from torch_cases import (BUCKET_HASH_B, BUCKET_HASH_CASES,  # noqa: E402
                         MULTIPROBE_CASES, bucket_hash_case, np_bucket_ids,
                         np_floor_words, np_mix_words, np_pack,
                         reciprocal_misses)


def _floors(fam, params, x):
    proj = (x.to(torch.float32) @ params["a"]).numpy().astype(np.float64)
    return np.floor((proj + params["b"].numpy()) / fam.w)


@pytest.mark.parametrize("name", sorted(BUCKET_HASH_CASES))
def test_bucket_ids_match_numpy_uint32(name):
    fam, params, x = bucket_hash_case(name, "cpu")
    got = fam.bucket_ids(params, x, BUCKET_HASH_B)
    assert got.dtype == torch.int32 and tuple(got.shape) == (x.shape[0],
                                                              fam.L)
    np.testing.assert_array_equal(
        got.numpy(), np_bucket_ids(fam, params, x, BUCKET_HASH_B))
    assert F.bucket_fn_for(fam, BUCKET_HASH_B)(params, x).equal(got)
    if name == "l1-wide-floors":         # Cauchy draws reach past 2^31
        f = _floors(fam, params, x)
        assert (f >= 2**31).any() and (f < -2**31).any()
    if name.startswith("pstable") or name.startswith("l"):
        assert (_floors(fam, params, x) < 0).any()    # negative floors wrap


def test_pstable_divides_truly_on_multiples_of_w():
    """On multiples of w = 0.7 where a reciprocal multiply floors one
    lower or higher, the codes are the true division's."""
    fam, params, x = bucket_hash_case("pstable-multiples", "cpu")
    v = reciprocal_misses(fam.w)
    assert len(v) > 100
    codes = fam.codes(params, x).numpy()
    want = np_floor_words(x.numpy() @ np.ones((1, fam.L * fam.k), np.float32),
                          np.zeros(fam.L * fam.k, np.float32), fam.w)
    np.testing.assert_array_equal(codes.reshape(x.shape[0], -1), want)
    floors = codes[:len(v), 0, 0].astype(np.uint32).view(np.int32)
    recip = np.floor(v * (np.float32(1) / np.float32(fam.w)))
    assert (recip != floors).all()


@pytest.mark.parametrize("d,L,k,probes", MULTIPROBE_CASES)
def test_multiprobe_buckets_match_numpy_uint32(d, L, k, probes):
    fam = F.SimHash(d=d, L=L, k=k)
    params = fam.init(torch.Generator().manual_seed(1))
    q = torch.from_numpy(np.random.default_rng(1).normal(
        size=(33, d)).astype(np.float32))
    got = mp.probe_buckets(fam, params, q, probes, BUCKET_HASH_B)
    codes = mp.probe_codes(fam, params, q, probes).numpy().astype(np.uint32)
    assert tuple(got.shape) == (33, L, probes)
    np.testing.assert_array_equal(got.numpy(),
                                  np_mix_words(codes, BUCKET_HASH_B))


def _no_kernel(*a, **k):
    raise AssertionError("the plain path launched the bucket hash kernel")


@pytest.mark.parametrize("name", ["simhash-k33", "l1-covertype", "l2-random",
                                  "bitsampling-k40"])
def test_cpu_meta_and_ref_take_the_plain_path(name, monkeypatch):
    monkeypatch.setattr(F._bh, "bucket_hash", _no_kernel)
    fam, params, x = bucket_hash_case(name, "cpu")
    want = fam.bucket_ids(params, x, BUCKET_HASH_B)
    for device in ("cpu", "meta"):
        p = {k: v.to(device) for k, v in params.items()}
        for impl in (None, "ref"):
            got = fam.bucket_ids(p, x.to(device), BUCKET_HASH_B, impl=impl)
            assert got.device.type == device and got.dtype == torch.int32
            assert tuple(got.shape) == tuple(want.shape)
            if device == "cpu":
                assert got.equal(want)
            assert not F.uses_kernel(torch.device(device), impl)
    assert fam.host_syncs == (1 if name[:2] in ("l1", "l2") else 0)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fam.bucket_ids(params, x, BUCKET_HASH_B, impl="cuda")


def _numpy_kernel(calls):
    """The kernel's wrapper, stood in by the numpy version of its spec; it
    keeps the wrapper's ``launches`` count, which the engine reads."""
    def bucket_hash(src, num_buckets, front, k, b=None, w=None):
        calls.append(front)
        bucket_hash.launches += 1
        a = src.numpy()
        if front == "words":
            words = a.astype(np.uint32)
        elif front == "sign":
            words = np_pack((a > 0).reshape(a.shape[0], -1, k))
        else:
            words = np_floor_words(a, b.numpy(), w).reshape(
                a.shape[0], -1, k)
        return torch.from_numpy(np_mix_words(words, num_buckets))
    bucket_hash.launches = 0
    return bucket_hash


def _index(kind, metric, x, impl=None):
    fam = make_family(metric, d=x.shape[1] * (32 if metric == "hamming"
                                              else 1), L=8,
                      r=6.0 if metric == "hamming" else 0.45)
    kw = dict(num_buckets=256, m=64, cap=64, seed=3, device="cpu", impl=impl,
              cost_model=CostModel(alpha=1.0, beta=1.0))
    if kind == "static":
        return HybridLSHIndex(fam, **kw).build(x)
    idx = DynamicHybridIndex(fam, delta_capacity=512,
                             policy=CompactionPolicy(delta_fill=1.0), **kw)
    idx.build(x[:1800])
    idx.insert(x[1800:])
    return idx


@pytest.mark.parametrize("metric,front", [("l2", "floor"),
                                          ("cosine", "sign"),
                                          ("hamming", "words")])
@pytest.mark.parametrize("kind", ["static", "streaming"])
def test_kernel_path_counts_its_batches_and_no_divisor_copy(
        kind, metric, front, monkeypatch):
    """With the kernel's path taken (its numpy stand-in): the family's
    front end, one kernel call a hash, ``hash_kernel_batches`` equal to
    the batches (read from the launches), the p-stable divisor's copy gone
    from ``syncs``, and the same answers as the plain path's index; an
    ``estimate()`` hashes too but counts in neither index."""
    if metric == "hamming":
        x = np.random.default_rng(0).integers(0, 2**32, (2048, 2),
                                              dtype=np.int64)
        q = x[:40] ^ 1
    else:
        x = clustered_dataset(2048, 32, n_clusters=16, dense_core_frac=0.25,
                              core_scale=0.02, seed=0, metric=metric)
        x, q = query_split(x, n_queries=40, seed=0)
    r = 6.0 if metric == "hamming" else 0.45
    plain = _index(kind, metric, x, impl="ref")    # the plain path, always
    calls = []
    monkeypatch.setattr(bh, "bucket_hash", _numpy_kernel(calls))
    monkeypatch.setattr(F, "_ops", types.SimpleNamespace(
        resolve_impl=lambda impl, device: "ref" if impl == "ref" else "cuda"))
    fast = _index(kind, metric, x)
    assert calls and set(calls) == {front}      # the build hashed through it
    h = plain.family.host_syncs
    for force in (None, "lsh", "linear"):
        n_calls = len(calls)
        a, b = fast.query(q, r, force=force), plain.query(q, r, force=force)
        assert len(calls) == n_calls + 1
        assert a.route.collisions.equal(b.route.collisions)
        assert a.neighbor_sets() == b.neighbor_sets()
    got, want = (i.index_stats()["query"] for i in (fast, plain))
    assert got["batches"] == want["batches"] == 3
    assert got["hash_kernel_batches"] == 3 and want["hash_kernel_batches"] == 0
    assert got["syncs"] == want["syncs"] - 3 * h
    n_calls = len(calls)
    for i in (fast, plain):
        i.estimate(q)
    assert len(calls) == n_calls + 1
    assert [i.index_stats()["query"] for i in (fast, plain)] == [got, want]


@pytest.mark.parametrize("args,kw,match", [
    ((torch.zeros(4, 6), 100, "sign"), {"k": 3}, "2\\^t"),
    ((torch.zeros(4, 6), 64, "cube"), {"k": 3}, "front must be"),
    ((torch.zeros(4, 6), 64, "sign"), {"k": 0}, "k >= 1"),
    ((torch.zeros(4, 6), 64, "sign"), {"k": 4}, "does not split"),
    ((torch.zeros(4, 6), 64, "floor"), {"k": 3}, "offsets b and width w"),
    ((torch.zeros(4, 6), 64, "sign"), {"k": 3}, "CUDA tensor"),
    ((torch.zeros(4, 2, dtype=torch.int64), 64, "words"), {"k": 2},
     "CUDA tensor")])
def test_kernel_wrapper_refuses_what_it_cannot_launch(args, kw, match):
    """The wrapper's checks run before any launch, so they hold here: a
    CPU tensor, a bucket count off a power of two, an unknown front, a
    projection that does not split into tables, a floor without b or w."""
    before = bh.bucket_hash.launches
    with pytest.raises(ValueError, match=match):
        bh.bucket_hash(*args, **kw)
    assert bh.bucket_hash.launches == before
