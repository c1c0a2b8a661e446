"""The mesh, ``ParallelConfig`` and the spec trees of ``repro_torch``
against ``repro``'s, in-process on the CPU.

  * the spec trees (``param_specs``, ``cache_specs``, ``state_specs``,
    ``batch_specs``) of all ten configs under eight ``ParallelConfig``s
    (no mesh, the defaults, ``fsdp=False``, ``seq_shard=False``,
    ``decode_seq_shard``, ``decode_kv_head_shard``, the long-context
    ``batch_axes=()`` with the cache over every axis, and data axes
    ``("pod", "data")``), equal as tuples; the reference's meshes are
    ``jax.make_mesh`` of ones (the spec functions read only the names);
  * every parameter of the port takes its leaf's spec
    (``train.step.named_specs``) and the state checks on a 2 x 2 mesh;
  * ``ShardMesh``'s named axes and its collectives over a subset of them;
  * ``ParallelConfig``'s checks and the meshes of ``launch.mesh``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models import cache_specs as jcache_specs  # noqa: E402
from repro.models import param_specs as jparam_specs  # noqa: E402
from repro.models.parallel import ParallelConfig as JPar  # noqa: E402
from repro.train import TrainConfig as JTrain  # noqa: E402
from repro.train import batch_specs as jbatch_specs  # noqa: E402
from repro.train import state_specs as jstate_specs  # noqa: E402
from repro_torch.core.distributed import ShardMesh, make_mesh  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import ParallelConfig  # noqa: E402
from repro_torch.models import cache_specs, param_specs  # noqa: E402
from repro_torch.models.transformer import layer_cache_specs  # noqa: E402
from repro_torch.train import (TrainConfig, batch_specs,  # noqa: E402
                               init_state, state_specs)
from repro_torch.train.step import check_state, named_specs  # noqa: E402

CPU = torch.device("cpu")
DA = ("data", "model")
PDA = ("pod", "data", "model")
# (name, axes, ParallelConfig fields), each under a mesh of ones
PARS = [
    ("defaults", DA, {}),
    ("no_fsdp", DA, dict(fsdp=False)),
    ("no_seq_shard", DA, dict(seq_shard=False)),
    ("decode_seq", DA, dict(decode_seq_shard=("model",))),
    ("kv_head", DA, dict(decode_kv_head_shard=True)),
    ("long_context", DA, dict(batch_axes=(),
                              decode_seq_shard=("data", "model"))),
    ("pod", PDA, dict(data_axes=("pod", "data"),
                      decode_seq_shard=("model",))),
]


def _pars(axes, kw):
    jm = jax.make_mesh((1,) * len(axes), axes)
    tm = tmesh.make_debug_mesh((1,) * len(axes), axes, device="cpu")
    return JPar(mesh=jm, **kw), ParallelConfig(mesh=tm, **kw)


@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
@pytest.mark.parametrize("name,axes,kw", [("no_mesh", None, {})] + PARS,
                         ids=lambda v: v if isinstance(v, str) else "")
def test_spec_trees_match_reference(arch, name, axes, kw):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jpar, tpar = ((JPar(), ParallelConfig()) if axes is None
                  else _pars(axes, kw))
    assert param_specs(tcfg, tpar) == jparam_specs(jcfg, jpar)
    assert cache_specs(tcfg, tpar) == jcache_specs(jcfg, jpar)
    assert state_specs(tcfg, tpar, TrainConfig()) == \
        jstate_specs(jcfg, jpar, JTrain())
    assert batch_specs(tcfg, tpar) == jbatch_specs(jcfg, jpar)
    for f in ("batch", "seq", "fsdp_axis"):
        assert getattr(tpar, f)() == getattr(jpar, f)()
    assert (tpar.n_model, tpar.batch_axes_) == \
        (jpar.n_model, jpar.batch_axes_)
    for stacked in (True, False):
        for f in ("w_col", "w_row", "w_vocab"):
            assert getattr(tpar, f)(stacked) == getattr(jpar, f)(stacked)


@pytest.mark.parametrize("arch", tconfigs.ARCH_NAMES)
def test_every_parameter_takes_its_leaf_spec(arch):
    """Each weight and moment of a reduced state gets its reference leaf's
    spec (a stacked leaf's without its leading None), every spec fits its
    tensor on a 2 x 2 CPU mesh (``check_state``), and each layer's
    caches take ``cache_specs``' entries in execution order."""
    cfg = tconfigs.reduced_config(tconfigs.get_config(arch))
    par = ParallelConfig(mesh=tmesh.make_debug_mesh((2, 2), device="cpu"),
                         decode_seq_shard=("model",))
    state = init_state(cfg, 0, device="cpu")
    weights = dict(state["params"].named_parameters())
    specs = named_specs(param_specs(cfg, par), weights, cfg)
    assert specs.keys() == weights.keys()
    assert specs["embed"] == specs["lm_head"] == ("model", ("data",))
    for name, spec in specs.items():
        assert len(spec) <= weights[name].ndim, name
    check_state(state, cfg, par)
    per_layer = layer_cache_specs(cfg, par)
    assert len(per_layer) == cfg.n_layers
    tree = cache_specs(cfg, par)
    n = len(cfg.pattern)
    for i, spec in enumerate(per_layer):
        src = (tree["blocks"][i % n] if i < n * cfg.n_repeats
               else tree["tail"][i - n * cfg.n_repeats])
        for k, v in spec.items():
            assert v == (src[k][1:] if i < n * cfg.n_repeats else src[k])
    # a state elsewhere than the mesh, or a spec that does not split
    bad = ParallelConfig(mesh=tmesh.make_debug_mesh((2, 2), device="meta"))
    with pytest.raises(ValueError, match="mesh on meta"):
        check_state(state, cfg, bad)
    odd = ParallelConfig(mesh=tmesh.make_debug_mesh((3, 2), device="cpu"))
    with pytest.raises(ValueError, match="does not split"):
        check_state(state, cfg, odd)


def test_shard_mesh_named_axes_and_subset_collectives():
    mesh = ShardMesh(["cpu"] * 8, ("data", "model"), (4, 2))
    assert mesh.shape == {"data": 4, "model": 2} and mesh.size == 8
    assert mesh.axis is None and mesh.axis_size(("data", "model")) == 8
    assert mesh.axis_size("model") == 2 and mesh.axis_size(()) == 1
    assert mesh.coords(5) == {"data": 2, "model": 1}
    assert mesh.axis_index(5, "data") == 2
    # the reference's rank = rank * size + axis_index, in the order given
    assert mesh.axis_index(5, ("data", "model")) == 5
    assert mesh.axis_index(5, ("model", "data")) == 6
    assert mesh.groups("model") == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert mesh.groups("data") == [[0, 2, 4, 6], [1, 3, 5, 7]]
    t = [torch.tensor([float(i), 10.0 - i]) for i in range(8)]
    got = mesh.psum(t, "model")
    for i in range(8):
        j = i - i % 2
        assert torch.equal(got[i], t[j] + t[j + 1])
    got = mesh.pmax(t, "data")
    assert torch.equal(got[3], torch.tensor([7.0, 9.0]))
    got = mesh.pmin(t, ("data", "model"))
    assert all(torch.equal(g, torch.tensor([0.0, 3.0])) for g in got)
    got = mesh.all_gather(t, "data")
    assert torch.equal(got[1], torch.stack([t[1], t[3], t[5], t[7]]))
    ring = mesh.ppermute(t, "data", [(0, 1), (1, 2)])
    assert torch.equal(ring[2], t[0]) and torch.equal(ring[4], t[2])
    assert torch.equal(ring[0], torch.zeros(2))
    sub = mesh.sub(("model", "data"))
    assert sub.shape == {"model": 2, "data": 4} and sub.size == 8
    assert mesh.sub("model").shape == {"model": 2}
    assert mesh.sub(()).size == 1
    with pytest.raises(KeyError):
        mesh.psum(t, "pod")
    with pytest.raises(ValueError):
        mesh.psum(t[:4], "data")
    with pytest.raises(ValueError):
        ShardMesh(["cpu"] * 6, ("data", "model"), (4, 2))
    with pytest.raises(ValueError):
        ShardMesh(["cpu"] * 4, ("data", "data"), (2, 2))
    # the one-axis mesh of the sharded indexes is unchanged
    one = make_mesh(3, device="cpu")
    assert one.shape == {"data": 3} and one.axis == "data"
    assert one.axis_names == ("data",)


def test_parallel_config_checks():
    with pytest.raises(TypeError, match="ShardMesh"):
        ParallelConfig(mesh=object())
    with pytest.raises(ValueError, match="one device"):
        ParallelConfig(mesh=ShardMesh(["cpu", "meta"], "model"))
    mesh = tmesh.make_debug_mesh((2, 2), device="cpu")
    with pytest.raises(ValueError, match="not in the mesh"):
        ParallelConfig(mesh=mesh, data_axes=("pod", "data"))
    with pytest.raises(ValueError, match="remat"):
        ParallelConfig(remat="all")
    par = ParallelConfig(mesh=mesh, moe_local_dispatch=True)
    assert par.active and par.n_model == 2
    assert par.axis_size(par.data_axes) == 2
    x = torch.zeros(4, 6, 8)
    assert par.shard(x, ("data",), "model", None) is x
    assert par.shard_activations(x) is x
    with pytest.raises(ValueError, match="more entries"):
        par.shard(x, None, None, None, None)
    with pytest.raises(ValueError, match="not in the mesh"):
        par.shard(x, "pod")
    with pytest.raises(ValueError, match="used twice"):
        par.shard(x, "model", "model")
    par.check(x, (("data", "model"), None), even=True)
    with pytest.raises(ValueError, match="does not split"):
        par.check(x, (None, ("data", "model")), even=True)
    # without a mesh every layout is the identity, any knob accepted
    off = ParallelConfig(moe_local_dispatch=True, decode_seq_shard=("x",))
    assert not off.active and off.shard(x, "anything") is x
    assert off.axis_size(("data",)) == 1


def test_launch_meshes_match_reference():
    for multi in (False, True):
        t = tmesh.make_production_mesh(multi_pod=multi)
        assert t.devices[0].type == "meta"
        assert t.size == (512 if multi else 256)
        assert tuple(t.axis_names) == (("pod", "data", "model") if multi
                                       else ("data", "model"))
        assert t.shape["data"] == t.shape["model"] == 16
        assert tmesh.data_axes(multi) == jmesh.data_axes(multi)
    m = tmesh.make_debug_mesh((4, 2), ("stage", "model"), device="cpu")
    assert m.shape == {"stage": 4, "model": 2} and set(m.devices) == {CPU}
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: make_debug_mesh() runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.make_debug_mesh()
