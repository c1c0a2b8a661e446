"""A configuration added with new files only: a temporary root holds the
repo's ``bench/`` as it is, plus a configuration and its
``BENCHMARK.json`` entries, a system module, a traffic file, a limits
file and a tiny size for the CPU that this test writes.  The
configuration is a cut one (its corpus held below the ``published``
count), and the repo's own per-cell checks pass on it.  Its system is a
toy retrieval encoder: token rows of varying lengths, mean-pooled over
each row's own tokens by a seeded embedding table, normalised, and
served from the port's static index; its check holds the program's
embeddings to a plain encoder (``embed_gap``) and judges r-NN on the
program's own corpus with ``bench/reference/judge.py``."""
import filecmp
import io
import json
import shutil

import pytest
import torch

from bench.tests import _tiny
from bench.tests.test_bench_files import (check_cell_files,
                                          check_limits_returned)

CELL = "toy_encoder.tokens"

CONFIG = {
    "name": "toy_encoder", "system": "toy_encoder",
    "deployment_seed": 20160619, "vocab": 512, "d": 48, "n": 20000,
    "doc_tokens": [6, 40], "query_pool": 96, "metric": "cosine",
    "family": "simhash", "L": 12, "delta": 0.1, "num_buckets": 1024,
    "m": 64, "cap": 128, "alpha": 1.0, "beta": 10.0,
    "precision": "float32 embeddings, projections and distances",
    "reduced": ["n"], "published": {"n": 1000000},
    "deployment": "one chip holds the whole index, its corpus cut from the "
                  "published count"}
TINY = {"config": {"n": 1500}, "mix": {"batch_queries": 32}}
MIX = {"batch_queries": 16, "query_tokens": [3, 24], "radius_quantile": 0.02}
LIMITS = {"embed_gap": 1e-5, "report_gap": 1e-3, "distance_gap": 3e-5,
          "route_gap": 1e-3, "collision_excess": 0, "estimate_gap": 1e-3}

SYSTEM = '''"""Toy retrieval: token rows encoded by a mean-pooled embedding table
and served from the port's static HybridLSHIndex."""
import torch

from bench.reference import judge as judge_lib
from bench.reference import lsh
from bench.systems import _index
from bench.systems.static_index import Snapshot


class Data:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def rows(gen, n, lo, hi, vocab):
    """n token rows of lo..hi tokens, padded with token 0 to hi."""
    dev = gen.device
    lens = torch.randint(lo, hi + 1, (n,), generator=gen, device=dev)
    tok = torch.randint(1, vocab, (n, hi), generator=gen, device=dev)
    pad = torch.arange(hi, device=dev)[None, :] >= lens[:, None]
    return tok.masked_fill(pad, 0), lens


def plain_encode(table, tok, lens):
    """The reference: float64 mean of each row's own tokens, normalised."""
    out = torch.stack([table[t[:n]].double().mean(0)
                       for t, n in zip(tok, lens.tolist())])
    return out / out.norm(dim=1, keepdim=True)


def encode(table, tok, lens):
    """The program's encoder: float32, masked mean over the padded rows."""
    emb = torch.nn.functional.embedding(tok, table)
    keep = torch.arange(tok.shape[1], device=tok.device)[None, :] < lens[:, None]
    v = (emb * keep[..., None]).sum(1) / lens[:, None]
    return v / v.norm(dim=1, keepdim=True)


def make_data(cfg, mix, dep, gen):
    table = torch.randn((cfg["vocab"], cfg["d"]), generator=dep,
                        device=dep.device)
    docs, doc_len = rows(dep, cfg["n"], *cfg["doc_tokens"], cfg["vocab"])
    ref = plain_encode(table, docs, doc_len)
    a = torch.randint(0, cfg["n"], (4096,), generator=dep, device=dep.device)
    b = torch.randint(0, cfg["n"], (4096,), generator=dep, device=dep.device)
    r = float(torch.quantile(1.0 - (ref[a] * ref[b]).sum(1),
                             mix["radius_quantile"]))
    queries, q_len = rows(gen, cfg["query_pool"], *mix["query_tokens"],
                          cfg["vocab"])
    return Data(table=table, docs=docs, doc_len=doc_len, queries=queries,
                q_len=q_len, r=r, params=lsh.draw_params(cfg, r, dep))


class Traffic:
    def __init__(self, mix, data, seed, device):
        self.batch = int(mix["batch_queries"])
        self.gen = torch.Generator(device=device).manual_seed(int(seed))
        self.data = data

    def next(self):
        idx = torch.randint(0, self.data.queries.shape[0], (self.batch,),
                            generator=self.gen, device=self.gen.device)
        return (self.data.queries[idx], self.data.q_len[idx]), idx

    def live(self):
        return _index.Live(0, self.data.docs.shape[0])


class System:
    def __init__(self, cfg, data, device):
        from repro_torch.core.cost_model import CostModel
        from repro_torch.core.index import HybridLSHIndex
        from repro_torch.core.lsh.families import make_family
        self.table, self.r = data.table, data.r
        fam = make_family(cfg["metric"], d=cfg["d"], L=cfg["L"], r=data.r,
                          delta=cfg["delta"])
        self.index = HybridLSHIndex(
            fam, num_buckets=cfg["num_buckets"], m=cfg["m"], cap=cfg["cap"],
            cost_model=CostModel(cfg["alpha"], cfg["beta"]),
            params=data.params, device=device)
        self.corpus = encode(self.table, data.docs, data.doc_len)
        self.index.build(self.corpus)

    def query(self, req):
        q = encode(self.table, *req)
        return q, self.index.query(q, self.r)

    def snapshot(self):
        return Snapshot(self.corpus.shape[0], self.corpus.device)

    def counters(self):
        return {}

    def close(self):
        corpus, self.corpus, self.index = self.corpus, None, None
        return corpus


def keep_traced(res, key):
    return None


def check(cfg, data, judged, traced, control, left):
    """The program's corpus (``left``) and query embeddings held to the
    plain encoder; r-NN judged on those embeddings.  No control."""
    gap = float((left.double() - plain_encode(
        data.table, data.docs, data.doc_len)).abs().max())
    bh = lsh.bucket_ids(cfg, data.params, left, data.r)
    out = {k: 0.0 for k in _index.ANSWER_CHECKS}
    n = due = 0
    for (qv, res), idx, live, snap in judged:
        ref = plain_encode(data.table, data.queries[idx], data.q_len[idx])
        gap = max(gap, float((qv.double() - ref).abs().max()))
        segs, n_scan, _ = snap.layout()
        st = judge_lib.RefState(segs, left, bh, cfg, n_scan)
        got = judge_lib.judge(st, qv, lsh.bucket_ids(cfg, data.params, qv,
                                                     data.r),
                              live, data.r, _index.answer(res))
        for k in out:
            out[k] = max(out[k], got[k])
        n += got["queries"]
        due += got["pairs_due"]
    seen = {"judged_queries": n, "pairs_due": due}
    return {"compared": {"embed_gap": gap, **out}, "judged": n,
            "readings": seen, "info": {"radius": data.r, **seen},
            "control": None, "work": None}
'''


def _root(tmp_path, limits=LIMITS, config=CONFIG, tiny=TINY):
    """The repo's ``bench/`` and ``BENCHMARK.json`` plus the new files
    (without a tiny size where ``tiny`` is None)."""
    root = tmp_path / "root"
    shutil.copytree(_tiny.ROOT / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((_tiny.ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "toy_encoder", "source": "https://arxiv.org/abs/1607.06179",
        "file": "bench/configs/toy_encoder.json", "reduced": ["n"],
        "why": "a test-only encoder: token rows mean-pooled into cosine rows"})
    bench["workloads"].append({
        "name": CELL, "config": "toy_encoder", "traffic": "toy_tokens",
        "chips": 1, "why": "16 token rows of 3-24 tokens a round, encoded "
                           "and served from the static index"})
    for m in bench["per_layer"]:
        if m["name"] == "device_idle_pct":
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    new = {"bench/configs/toy_encoder.json": json.dumps(config),
           "bench/traffic/toy_tokens.json": json.dumps(MIX),
           f"bench/limits/{CELL}.json": json.dumps(limits),
           "bench/systems/toy_encoder.py": SYSTEM}
    if tiny is not None:
        new["bench/tests/tiny/toy_encoder.json"] = json.dumps(tiny)
    for rel, text in new.items():
        assert not (root / rel).exists()
        (root / rel).write_text(text)
    return root, new


def _only_new_files(root, new):
    cmp = filecmp.dircmp(_tiny.ROOT / "bench", root / "bench",
                         ignore=["__pycache__"])
    added, changed = [], []

    def walk(d, rel):
        added.extend(f"{rel}/{n}" for n in d.right_only)
        changed.extend(f"{rel}/{n}" for n in d.diff_files)
        assert not d.left_only
        for name, sub in d.subdirs.items():
            walk(sub, f"{rel}/{name}")
    walk(cmp, "bench")
    assert not changed
    assert sorted(added) == sorted(new)


@pytest.mark.parametrize("trace", [False, True])
def test_new_files_give_a_correct_line(tmp_path, trace):
    root, new = _root(tmp_path)
    _only_new_files(root, new)
    err = io.StringIO()
    res = _tiny.run(CELL, root=root, trace=trace, err=err)
    info = json.loads(next(ln[5:] for ln in err.getvalue().splitlines()
                           if ln.startswith("info ")))
    assert info["judged_queries"] > 0 and info["pairs_due"] > 0
    checks = res["checks"]
    assert res["correct"], checks
    assert list(checks) == list(LIMITS)
    assert 0 < checks["embed_gap"]["value"] <= LIMITS["embed_gap"]
    assert res["attempted"] > 0 and list(res)[-1] == "checks"


def test_altered_embedding_is_not_correct(tmp_path):
    root, _ = _root(tmp_path)

    def pool_the_padding(encode):
        # each row's padding pooled too, as one shape for requests of
        # mixed lengths would pool it
        return lambda table, tok, lens: encode(
            table, tok, torch.full_like(lens, tok.shape[1]))
    with _tiny.wrapped("systems", "encode", pool_the_padding):
        res = _tiny.run(CELL, root=root)
    assert not res["correct"]
    assert res["checks"]["embed_gap"]["value"] > LIMITS["embed_gap"]


def test_a_limit_the_check_does_not_return_raises(tmp_path):
    root, _ = _root(tmp_path, {**LIMITS, "tokens_gap": 0})
    with pytest.raises(KeyError, match="tokens_gap"):
        _tiny.run(CELL, root=root)


def test_the_repos_per_cell_checks_pass_on_the_cut_toy(tmp_path):
    root, new = _root(tmp_path)
    _only_new_files(root, new)
    assert "bench/tests/tiny/toy_encoder.json" in new
    check_cell_files(root, CELL)
    check_limits_returned(root, CELL)


def test_a_configuration_without_a_tiny_size_raises_before_set_up(tmp_path):
    root, _ = _root(tmp_path, tiny=None)
    made = []

    def spy(make_data):
        def making(*a, **k):
            made.append(1)
            return make_data(*a, **k)
        return making
    with _tiny.wrapped("systems", "make_data", spy):
        with pytest.raises(KeyError, match="tiny/toy_encoder.json"):
            _tiny.run(CELL, root=root)
    assert made == []


def test_a_cut_without_the_published_value_fails_the_file_check(tmp_path):
    root, _ = _root(tmp_path, config={**CONFIG, "published": {}})
    with pytest.raises(AssertionError, match="'n'"):
        check_cell_files(root, CELL)
