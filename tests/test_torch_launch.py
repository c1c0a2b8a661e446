"""The launch tail of ``repro_torch`` (``launch.specs``, ``launch.dryrun``,
``launch.dryrun_retrieval``) on the meta device, against ``repro``'s.

  * specs, at full size, no step run: the reference's half runs once, in
    a subprocess with 512 host devices
    (``XLA_FLAGS=--xla_force_host_platform_device_count=512``) on
    ``repro.launch.mesh.make_production_mesh``, with ``jax.eval_shape``
    and ``NamedSharding.shard_shape`` only.  For every arch, shape and
    mesh: ``shape_applicable`` agrees, ``make_par``'s fields are equal
    (the mesh aside; the reference's ``grad_compression`` and
    ``attn_head_shard``, which the port does not have, stay off), every
    leaf of the abstract params, state, caches and batch has the
    reference's shape and dtype (the port's trees mapped through
    ``train.state_tree`` / ``params_tree`` and the cache layout below),
    and ``input_bytes_per_device`` equals the reference's ``_leaf_bytes``
    sum exactly (or both raise);
  * ``dryrun.run_cell`` on a 2 x 2 meta mesh at ``reduced_config`` for
    every arch and step kind: status ok, the reference's record keys, and
    the global FLOPs of the sharded step equal to the unsharded step's
    (each shard's part of a ``shard_map`` site is a slice of the whole);
  * ``dryrun_retrieval.run`` at small n on 4 meta shards: the estimate
    counted once, both routes counted and summed, the psum / pmax wire
    bytes by formula;
  * the CLI: an unknown ``--override`` field raises, naming the fields; a
    failing cell is recorded with status ``error`` and exits 1.
"""
import functools
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.configs import SHAPES, ShapeSpec  # noqa: E402
from repro_torch.launch import dryrun, dryrun_retrieval  # noqa: E402
from repro_torch.launch.mesh import (make_debug_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.launch.specs import (abstract_caches,  # noqa: E402
                                      abstract_params, abstract_state,
                                      input_bytes_per_device, input_specs,
                                      make_par)
from repro_torch.train.step import params_tree, state_tree  # noqa: E402

_SRC = os.path.join(os.path.dirname(__file__), "..", "src")
META = torch.device("meta")

_REF_SCRIPT = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import numpy as np
import jax
from repro.configs import ARCH_NAMES, SHAPES, get_config, shape_applicable
from repro.launch.mesh import make_production_mesh
from repro.launch.specs import (abstract_caches, abstract_params,
                                abstract_state, input_specs, make_par,
                                _batch_struct)


def leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): [list(a.shape), a.dtype.name]
            for p, a in flat}


def plain(v):
    return list(v) if isinstance(v, tuple) else v


out = {"cells": {}, "state": {}, "params": {}, "caches": {}, "batch": {}}
meshes = {mp: make_production_mesh(multi_pod=mp) for mp in (False, True)}
for arch in ARCH_NAMES:
    cfg = get_config(arch)
    out["state"][arch] = leaves(abstract_state(cfg))
    out["params"][arch] = leaves(abstract_params(cfg))
    for sn, shape in SHAPES.items():
        key = f"{arch}|{sn}"
        b, s = shape.global_batch, shape.seq_len
        out["batch"][key] = leaves(_batch_struct(
            cfg, b, s, with_labels=shape.kind == "train"))
        for mp, mesh in meshes.items():
            ok, _ = shape_applicable(cfg, shape)
            par = make_par(mesh, mp, cfg, shape)
            cell = {"applicable": ok,
                    "par": {f.name: plain(getattr(par, f.name))
                            for f in dataclasses.fields(par)
                            if f.name != "mesh"}}
            if shape.kind != "train" and not mp:
                out["caches"][key] = leaves(abstract_caches(cfg, b, s, par))
            args, in_sh, _ = input_specs(cfg, shape, par)
            try:
                cell["bytes"] = sum(jax.tree_util.tree_leaves(
                    jax.tree_util.tree_map(
                        lambda a, sh: int(np.prod(sh.shard_shape(a.shape)))
                        * a.dtype.itemsize, args, in_sh)))
            except ValueError as e:
                cell["bytes"] = "raise: " + str(e)
            out["cells"][f"{key}|{int(mp)}"] = cell
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
print("RESULT ok")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's specs of every cell (one subprocess)."""
    path = tmp_path_factory.mktemp("launch") / "specs.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=_SRC)
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _REF_SCRIPT, str(path)],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nERR:\n{out.stderr}"
    assert "RESULT ok" in out.stdout
    return json.loads(path.read_text())


def _leaves(tree, prefix=""):
    """{jax keystr path: [shape, dtype name]} of a tree of dicts, tuples,
    lists and tensors."""
    if isinstance(tree, torch.Tensor):
        return {prefix: [list(tree.shape), str(tree.dtype)[len("torch."):]]}
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree))
    out = {}
    for k, v in items:
        out.update(_leaves(v, prefix + (f"[{k!r}]" if isinstance(tree, dict)
                                        else f"[{k}]")))
    return out


def _caches_tree(caches, cfg):
    """The port's caches (one dict a layer, in execution order) in the
    reference's layout: each pattern position's layers stacked on a
    leading repeat axis, then the tail's."""
    n, r = len(cfg.pattern), cfg.n_repeats
    layers = caches["blocks"]
    blocks = tuple({k: torch.stack([layers[j + i * n][k] for i in range(r)])
                    for k in layers[j]} for j in range(n))
    return {"blocks": blocks, "tail": tuple(layers[n * r:])}


@functools.lru_cache(maxsize=None)
def _state(arch):
    return abstract_state(tconfigs.get_config(arch))


@pytest.mark.parametrize("shape_name", tuple(SHAPES))
@pytest.mark.parametrize("arch", tconfigs.ARCH_NAMES)
def test_specs_match_reference(arch, shape_name, ref):
    cfg = tconfigs.get_config(arch)
    shape = SHAPES[shape_name]
    key = f"{arch}|{shape_name}"
    if shape_name == "train_4k":
        assert _leaves(state_tree(_state(arch), cfg)) == ref["state"][arch]
        params = abstract_params(cfg)
        assert _leaves(params_tree(dict(params.named_parameters()), cfg)) \
            == ref["params"][arch]
    b, s = shape.global_batch, shape.seq_len
    for mp in (False, True):
        cell = ref["cells"][f"{key}|{int(mp)}"]
        mesh = make_production_mesh(multi_pod=mp)
        assert tconfigs.shape_applicable(cfg, shape)[0] == cell["applicable"]
        par = make_par(mesh, mp, cfg, shape)
        want = dict(cell["par"])
        assert want.pop("grad_compression") is False
        assert want.pop("attn_head_shard") is False
        got = {k: list(v) if isinstance(v, tuple) else v
               for k, v in vars(par).items() if k != "mesh"}
        assert got == want
        if shape.kind != "train" and not mp:
            caches = abstract_caches(cfg, b, s, par)
            assert _leaves(_caches_tree(caches, cfg)) == ref["caches"][key]
        args, specs, _ = input_specs(cfg, shape, par)
        batch = args[1] if shape.kind != "decode" else None
        if batch is not None:
            assert _leaves(batch) == ref["batch"][key]
        if isinstance(cell["bytes"], str):
            with pytest.raises(ValueError):
                input_bytes_per_device(args, specs, mesh)
        else:
            assert input_bytes_per_device(args, specs, mesh) == cell["bytes"]


def test_parallel_helpers_of_the_launch_tail():
    """``n_data``, ``w_replicated``, ``spec_bytes`` and ``shard_shape``
    (``NamedSharding.shard_shape``: each dim over its axes' size, an
    uneven split raises)."""
    from repro_torch.models import ParallelConfig
    from repro_torch.models.parallel import shard_shape, spec_bytes
    for mp, n in ((False, 16), (True, 32)):
        mesh = make_production_mesh(multi_pod=mp)
        par = make_par(mesh, mp, tconfigs.get_config("yi-6b"),
                       SHAPES["train_4k"])
        assert par.n_data == n and par.n_model == 16
    assert ParallelConfig().n_data == 1
    assert par.w_replicated() == (None,) and par.w_replicated(False) == ()
    assert spec_bytes(torch.empty(3, 5, dtype=torch.bfloat16,
                                  device=META)) == 30
    mesh = make_production_mesh(multi_pod=True)
    assert shard_shape((64, 4096, 7), (("pod", "data"), "model"), mesh) == \
        (2, 256, 7)
    assert shard_shape((5,), (), mesh) == (5,)
    with pytest.raises(ValueError, match="does not split"):
        shard_shape((48, 8), (None, "model"), mesh)
    with pytest.raises(ValueError, match="more entries"):
        shard_shape((48,), (None, "model"), mesh)


# ------------------------------------------------------------- dry runs
_KEYS = {"arch", "shape", "mesh", "tag", "status", "chips", "memory",
         "input_bytes_per_device", "cost", "collectives",
         "collective_counts", "bytes_by_op", "terms", "params",
         "active_params"}
_TERMS = {"compute_s", "memory_s", "collective_s", "dominant",
          "model_flops_global", "useful_flops_ratio", "roofline_fraction"}


@pytest.mark.parametrize("arch", tconfigs.ARCH_NAMES)
def test_run_cell_on_a_small_meta_mesh(arch):
    cfg = tconfigs.reduced_config(tconfigs.get_config(arch))
    mesh = make_debug_mesh((2, 2), device="meta")
    shapes = [ShapeSpec("train", 32, 4, "train"),
              ShapeSpec("prefill", 32, 4, "prefill"),
              ShapeSpec("decode", 32, 4, "decode")]
    if cfg.supports_long_context:
        shapes.append(ShapeSpec("long_500k", 64, 1, "decode"))
    for shape in shapes:
        rec = dryrun.run_cell(arch, shape.name, False, cfg=cfg, shape=shape,
                              mesh=mesh)
        assert rec["status"] == "ok", rec
        assert _KEYS <= rec.keys() and _TERMS <= rec["terms"].keys()
        assert rec["chips"] == 4 and rec["mesh"] == "2x2"
        assert rec["cost"]["flops"] == rec["cost_global"]["flops"] / 4 > 0
        assert rec["input_bytes_per_device"] > 0
        assert rec["memory"]["peak_live_bytes_global"] > 0
        # the vocab-sharded embedding reduces over 'model'
        assert rec["collective_counts"]["all-reduce"] > 0
        # a sharded step's shard parts add up to the unsharded step
        whole = dryrun.run_cell(arch, shape.name, False, cfg=cfg,
                                shape=shape, mesh=make_debug_mesh(
                                    (1, 1), device="meta"))
        assert rec["cost_global"]["flops"] == whole["cost_global"]["flops"]
    with pytest.raises(ValueError, match="meta device"):
        dryrun.run_cell(arch, "train", False, cfg=cfg, shape=shapes[0],
                        mesh=make_debug_mesh((2, 2), device="cpu"))


def test_dryrun_retrieval_counts_the_estimate_once_and_both_routes():
    q, n, d, L, m = 16, 4096, 32, 4, 16
    rec = dryrun_retrieval.run(n_total=n, d=d, queries=q, L=L, B=256, m=m,
                               cap=8, max_out=16,
                               mesh=make_debug_mesh((4, 2), device="meta"))
    assert rec["status"] == "ok" and rec["shards"] == 4 and rec["chips"] == 8
    est, routes, both = rec["estimate"], rec["routes"], rec["both_routes"]
    # the estimate: one psum of the (Q,) int32 collisions, one pmax of the
    # (Q, m) uint8 registers; the routes reduce nothing
    assert est["collective_counts"]["all-reduce"] == 2
    assert est["collectives"]["all-reduce"] == 2 * (4 * q + q * m)
    for r in ("lsh", "linear"):
        assert routes[r]["collective_counts"]["all-reduce"] == 0
        assert routes[r]["collectives"]["all-reduce"] == 0
    # the queries hashed once (the estimate's only product), the linear
    # route one full scan (2 Q n d), the sum of all three recorded
    k = rec["hashing"]["flops"] / (2 * q * d * L)
    assert k == int(k) >= 1
    assert est["flops"] == rec["hashing"]["flops"]
    assert routes["linear"]["flops"] == 2 * q * n * d
    assert rec["terms"]["model_flops_global"] == 2 * q * n * d
    for key in ("flops", "bytes accessed"):
        assert both[key] == est[key] + routes["lsh"][key] \
            + routes["linear"][key]
        assert routes["lsh"][key] >= 0
    assert rec["cost"]["flops"] == rec["hashing"]["flops"] + (
        both["flops"] - rec["hashing"]["flops"]) / 4
    assert rec["collectives"] == est["collectives"]


def test_cli_overrides_and_failing_cells(tmp_path, monkeypatch, capsys):
    with pytest.raises(ValueError, match="the fields are .*remat"):
        dryrun.main(["--arch", "yi-6b", "--shape", "train_4k",
                     "--override", "remat_everything=true"])
    assert dryrun.parse_overrides("remat=none,attn_chunk_q=256,"
                                  "fsdp=false") == \
        {"remat": "none", "attn_chunk_q": 256, "fsdp": False}
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "yi-6b", "--shape", "decode_32k",
                     "--override", "remat=all", "--tag", "bad"])
    assert e.value.code == 1
    rec = json.loads((tmp_path / "yi-6b__decode_32k__16x16__bad.json")
                     .read_text())
    assert rec["status"] == "error" and "remat" in rec["error"]
    # a skipped cell (no long context for Yi) exits 0
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "yi-6b", "--shape", "long_500k"])
    assert e.value.code == 0
    assert json.loads((tmp_path / "yi-6b__long_500k__16x16.json")
                      .read_text())["status"] == "skipped"
    assert "skipped" in capsys.readouterr().out
