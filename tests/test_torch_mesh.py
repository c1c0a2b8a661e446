"""The seven per-shard sites of ``repro_torch`` under a mesh against
``repro``'s ``shard_map`` runs, on the CPU.

The reference's half runs once, in a subprocess with eight host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``), on meshes made
with ``axis_types=(AxisType.Auto,) * n``: jax 0.9's ``jax.make_mesh``
makes Explicit axes, on which the reference's ``with_sharding_constraint``
raises (the cause of ``tests/test_distributed.py::
test_sharded_train_step_matches_single_device``'s failure).  It reads
the inputs from a numpy file this module writes (seeded) and writes its
outputs; the port's half runs here on CPU ``ShardMesh``es of the same
shapes.  Tolerances (float32):

  * ``embed`` (4 x 2 mesh, vocab over 'model'): bit-equal;
  * ``softmax_xent`` (4 x 2): loss and grads of head and h at rtol 1e-5
    (grads with an atol of 1e-7);
  * ``greedy_sample`` (4 x 2): equal ids, rows built to tie across two
    model shards and within one (the lowest id wins);
  * ``flash_decode`` sequence-sharded (2 x 4, over 'model' and over
    ('data', 'model')): 2e-5, on ``test_distributed``'s shapes and
    lengths [64, 50, 33, 7];
  * ``_moe_apply_local`` (4 x 2, four batch shards): output at 1e-5, aux
    at 1e-6; the local dispatch differs from the global one on inputs
    where the capacity binds, as the reference's does;
  * ``compressed_psum`` / ``apply_ef`` (an 8-shard 'pod' axis): equal
    int8 codes and scale, outputs at 1e-6 relative to the largest entry
    (the residuals to the gradients' largest entry);
  * ``gpipe`` (4 stages of a 4 x 2 mesh, 8 micro-batches): 2e-5,
    ``bubble_fraction`` exact;
  * the mesh train step (4 x 2, batch 8 x 16) of reduced float32 Yi-6B
    and Granite-MoE (``moe_local_dispatch=True``) from the reference's
    initial state: loss at rtol 1e-5; the first moment (0.1 x the clipped
    grad) at rtol 1e-5 with an atol of 1e-6 x the leaf's largest entry;
    the weights after one step at rtol 1e-5 with an atol of 1e-5 x the
    leaf's largest entry, where the grad is at least 100 x AdamW's eps
    (the first step moves an entry by lr g / (|g| + eps), so that where
    |g| is near eps the grad's last bits decide the move, in the
    reference's own mesh and single-device steps too).

``launch.train --devices 4 --device cpu`` runs a reduced config for two
steps in a subprocess; ``--coordinator`` raises.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro.data import lm_batch as jlm_batch  # noqa: E402
from repro.train import TrainConfig as JTrain  # noqa: E402
from repro.train import init_state as jinit_state  # noqa: E402
from repro_torch.distributed import bubble_fraction, gpipe  # noqa: E402
from repro_torch.interop import train_state_from_numpy  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models import ParallelConfig  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import embedding as temb  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.optim import compression  # noqa: E402
from repro_torch.train import TrainConfig, make_jitted_train_step  # noqa: E402
from repro_torch.train.step import params_tree  # noqa: E402

_SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCHS = ("yi-6b", "granite-moe-1b-a400m")

_REF_SCRIPT = r"""
import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import AxisType, PartitionSpec as P
from repro.configs import get_config, reduced_config
from repro.data import lm_batch
from repro.distributed import gpipe
from repro.models import embedding as emb
from repro.models.attention import flash_decode
from repro.models.moe import moe_apply
from repro.models.parallel import ParallelConfig
from repro.optim.compression import _quantize, apply_ef, compressed_psum
from repro.train.step import TrainConfig, init_state, make_jitted_train_step

inp = dict(np.load(sys.argv[1]))
out = {}


def mesh(shape, axes):
    return jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))


m42 = mesh((4, 2), ("data", "model"))
par = ParallelConfig(mesh=m42, data_axes=("data",))
out["embed"] = jax.jit(lambda t, i: emb.embed(t, i, par))(
    inp["table"], inp["ids"])
xent = lambda hd, h: emb.softmax_xent(hd, h, jnp.asarray(inp["labels"]),
                                      par, chunk=4)
out["xent"], (out["xent_dhead"], out["xent_dh"]) = jax.jit(
    jax.value_and_grad(xent, argnums=(0, 1)))(inp["head"], inp["h"])
out["greedy"] = jax.jit(lambda hd, h: emb.greedy_sample(hd, h, par))(
    inp["tie_head"], inp["h_last"])

m24 = mesh((2, 4), ("data", "model"))
for name, kw, axes in (("model", {}, ("model",)),
                       ("all", {"batch_axes": ()}, ("data", "model"))):
    p = ParallelConfig(mesh=m24, data_axes=("data",), decode_seq_shard=axes,
                       **kw)
    out["flash_" + name] = jax.jit(
        lambda *a: flash_decode(*a, p, seq_axes=axes))(
        inp["fq"], inp["fk"], inp["fv"], inp["flen"])

moe_p = {k: inp["moe_" + k] for k in ("router", "wi", "wg", "wo")}
for name, pp in (("local", ParallelConfig(mesh=m42, moe_local_dispatch=True)),
                 ("global", None)):
    out["moe_" + name], out["moe_" + name + "_aux"] = jax.jit(
        lambda p_, x: moe_apply(p_, x, top_k=2, capacity_factor=1.25,
                                par=pp))(moe_p, inp["moe_x"])

m8 = mesh((8,), ("pod",))


def codes(xs):
    q, s = _quantize(xs[0], "pod")
    return q[None], s


out["ef_codes"], out["ef_scale"] = jax.jit(shard_map(
    codes, mesh=m8, in_specs=P("pod"), out_specs=(P("pod"), P()),
    check_rep=False))(inp["ef_x"])
out["cpsum"] = jax.jit(shard_map(
    lambda xs: compressed_psum(xs[0], "pod", 8), mesh=m8, in_specs=P("pod"),
    out_specs=P(None), check_rep=False))(inp["ef_x"])


def ef_body(g, e):
    red, ef = apply_ef({k: v[0] for k, v in g.items()},
                       {k: v[0] for k, v in e.items()}, "pod", 8)
    return red, {k: v[None] for k, v in ef.items()}


red, ef = jax.jit(shard_map(
    ef_body, mesh=m8, in_specs=(P("pod"), P("pod")),
    out_specs=(P(), P("pod")), check_rep=False))(
    {"a": inp["ef_x"], "b": inp["ef_b"]},
    {"a": inp["ef_e"], "b": np.zeros_like(inp["ef_b"])})
for k in ("a", "b"):
    out["ef_red_" + k], out["ef_res_" + k] = red[k], ef[k]

mst = mesh((4, 2), ("stage", "model"))
out["gpipe"] = jax.jit(lambda p_, x: gpipe(
    lambda pp, h: jnp.tanh(h @ pp["w"] + pp["b"]), p_, x, mesh=mst,
    axis="stage"))({"w": inp["pw"], "b": inp["pb"]}, inp["pxs"])

tcfg = TrainConfig(total_steps=10, warmup_steps=0)
for arch, kw in (("yi-6b", {}),
                 ("granite-moe-1b-a400m", {"moe_local_dispatch": True})):
    cfg = dataclasses.replace(reduced_config(get_config(arch)),
                              dtype="float32")
    p = ParallelConfig(mesh=m42, data_axes=("data",), seq_shard=True,
                       attn_chunk_q=8, attn_chunk_k=8, logits_chunk=8, **kw)
    state = init_state(cfg, jax.random.PRNGKey(0), tcfg)
    batch = lm_batch(0, 0, batch=8, seq=16, vocab=cfg.vocab, cfg=cfg)
    st, m = make_jitted_train_step(cfg, p, tcfg)(state, batch)
    out["train_" + arch + "_loss"] = m["loss"]
    for part, tree in (("params", st["params"]), ("m", st["opt"]["m"])):
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
            out[f"train_{arch}_{part}/" + jax.tree_util.keystr(path)] = leaf
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
print("RESULT ok")
"""


def _inputs():
    rng = np.random.default_rng(0)

    def normal(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    d = {"table": normal(48, 16),
         "ids": rng.integers(0, 48, (8, 6)).astype(np.int32),
         "head": normal(48, 16), "h": normal(8, 12, 16),
         "labels": rng.integers(0, 48, (8, 12)).astype(np.int32),
         "h_last": normal(8, 16),
         "fq": normal(4, 8, 16), "fk": normal(4, 64, 2, 16),
         "fv": normal(4, 64, 2, 16),
         "flen": np.array([64, 50, 33, 7], np.int32),
         "moe_router": normal(32, 8), "moe_wi": normal(8, 32, 64, scale=0.2),
         "moe_wg": normal(8, 32, 64, scale=0.2),
         "moe_wo": normal(8, 64, 32, scale=0.2), "moe_x": normal(8, 16, 32),
         "ef_x": normal(8, 1024, scale=0.01),
         "ef_e": normal(8, 1024, scale=1e-4), "ef_b": normal(8, 37),
         "pw": normal(4, 16, 16, scale=0.3), "pb": normal(4, 16, scale=0.1),
         "pxs": normal(8, 4, 16)}
    d["labels"][0, :5] = -1                  # ignored
    # ties: row 0's best logit at ids 5 and 29 (model shards 0 and 1 of a
    # 48-row head), row 1's at ids 3 and 7 (both in shard 0)
    head = normal(48, 16)
    head[5] = head[29] = 4 * d["h_last"][0]
    head[3] = head[7] = 4 * d["h_last"][1]
    d["tie_head"] = head
    return d


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's outputs (one subprocess) and the inputs."""
    tmp = tmp_path_factory.mktemp("mesh")
    inp = _inputs()
    np.savez(tmp / "in.npz", **inp)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = _SRC
    out = subprocess.run(
        [sys.executable, "-c", _REF_SCRIPT, str(tmp / "in.npz"),
         str(tmp / "out.npz")], env=env, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nERR:\n{out.stderr}"
    assert "RESULT ok" in out.stdout
    with np.load(tmp / "out.npz") as z:
        outputs = {k: z[k] for k in z.files}
    return inp, outputs


def _t(a):
    return torch.from_numpy(np.array(a))


def _par(shape, axes=("data", "model"), **kw):
    return ParallelConfig(mesh=make_debug_mesh(shape, axes, device="cpu"),
                          **kw)


def test_embed_is_bit_equal(ref):
    inp, out = ref
    got = temb.embed(_t(inp["table"]), _t(inp["ids"]).long(), _par((4, 2)))
    np.testing.assert_array_equal(got.numpy(), out["embed"])


def test_softmax_xent_value_and_grads(ref):
    inp, out = ref
    head = _t(inp["head"]).requires_grad_()
    h = _t(inp["h"]).requires_grad_()
    loss = temb.softmax_xent(head, h, _t(inp["labels"]).long(),
                             _par((4, 2)), chunk=4)
    dhead, dh = torch.autograd.grad(loss, [head, h])
    np.testing.assert_allclose(float(loss.detach()), out["xent"], rtol=1e-5)
    np.testing.assert_allclose(dhead.numpy(), out["xent_dhead"], rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(dh.numpy(), out["xent_dh"], rtol=1e-5,
                               atol=1e-7)


def test_greedy_sample_ties_go_to_the_lowest_id(ref):
    inp, out = ref
    got = temb.greedy_sample(_t(inp["tie_head"]), _t(inp["h_last"]),
                             _par((4, 2)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), out["greedy"])
    assert got[:2].tolist() == [5, 3]


@pytest.mark.parametrize("name,axes,kw", [
    ("model", ("model",), {}), ("all", ("data", "model"),
                                {"batch_axes": ()})])
def test_flash_decode_sequence_sharded(ref, name, axes, kw):
    inp, out = ref
    par = _par((2, 4), decode_seq_shard=axes, **kw)
    got = tattn.flash_decode(_t(inp["fq"]), _t(inp["fk"]), _t(inp["fv"]),
                             _t(inp["flen"]), par, seq_axes=axes)
    np.testing.assert_allclose(got.numpy(), out["flash_" + name], rtol=2e-5,
                               atol=2e-5)


def test_moe_local_dispatch(ref):
    inp, out = ref
    params = {k: _t(inp["moe_" + k]) for k in ("router", "wi", "wg", "wo")}
    kw = dict(top_k=2, capacity_factor=1.25)
    local, aux = tmoe.moe_apply(params, _t(inp["moe_x"]),
                                par=_par((4, 2), moe_local_dispatch=True),
                                **kw)
    np.testing.assert_allclose(local.numpy(), out["moe_local"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux), out["moe_local_aux"], rtol=1e-6)
    glob, gaux = tmoe.moe_apply(params, _t(inp["moe_x"]), **kw)
    np.testing.assert_allclose(glob.numpy(), out["moe_global"], rtol=1e-5,
                               atol=1e-5)
    # a shard's capacity is a quarter of the batch's: where it binds, the
    # two dispatches keep other pairs, in both packages
    assert np.abs(out["moe_local"] - out["moe_global"]).max() > 0.1
    assert float((local - glob).abs().max()) > 0.1
    # without a token a shard (a decode step of B < shards) it is global
    one = _t(inp["moe_x"])[:2, :1]
    a, _ = tmoe.moe_apply(params, one,
                          par=_par((4, 2), moe_local_dispatch=True), **kw)
    assert torch.equal(a, tmoe.moe_apply(params, one, **kw)[0])


def test_compressed_psum_and_apply_ef(ref):
    inp, out = ref
    mesh = make_debug_mesh((8,), ("pod",), device="cpu")
    xs = [_t(x) for x in inp["ef_x"]]
    codes, scales = compression._quantize(xs, mesh, "pod")
    np.testing.assert_array_equal(np.stack([c.numpy() for c in codes]),
                                  out["ef_codes"])
    assert all(float(s) == float(out["ef_scale"]) for s in scales)

    def close(got, want, scale=None):
        err = np.abs(got - want).max() / np.abs(
            want if scale is None else scale).max()
        assert err <= 1e-6, err

    for got in compression.compressed_psum(xs, mesh, "pod", 8):
        close(got.numpy(), out["cpsum"])
    grads = [{"a": _t(a), "b": _t(b)} for a, b in zip(inp["ef_x"],
                                                      inp["ef_b"])]
    ef = compression.init_ef({"a": xs[0], "b": _t(inp["ef_b"][0])})
    ef = [dict(ef, a=_t(e)) for e in inp["ef_e"]]
    red, res = compression.apply_ef(grads, ef, mesh, "pod", 8)
    for k in ("a", "b"):
        for r in red:
            close(r[k].numpy(), out["ef_red_" + k])
        # g + e - q * scale: one rounding of g + e apart (a fused
        # multiply-add in XLA), relative to the gradients' largest entry
        close(np.stack([r[k].numpy() for r in res]), out["ef_res_" + k],
              np.stack([g[k].numpy() for g in grads]))
    # against the plain mean, as test_distributed's compressed psum test
    want = inp["ef_x"].mean(0)
    err = np.abs(red[0]["a"].numpy() - want).max() / np.abs(want).max()
    assert err < 0.02


def test_gpipe_matches_reference_and_sequential(ref):
    inp, out = ref
    mesh = make_debug_mesh((4, 2), ("stage", "model"), device="cpu")
    w, b, xs = _t(inp["pw"]), _t(inp["pb"]), _t(inp["pxs"])
    got = gpipe(lambda p, h: torch.tanh(h @ p["w"] + p["b"]),
                {"w": w, "b": b}, xs, mesh=mesh, axis="stage")
    np.testing.assert_allclose(got.numpy(), out["gpipe"], rtol=2e-5,
                               atol=2e-5)
    seq = xs
    for s in range(4):
        seq = torch.tanh(seq @ w[s] + b[s])
    np.testing.assert_allclose(got.numpy(), seq.numpy(), rtol=2e-5,
                               atol=2e-5)
    # one entry a stage is the same schedule
    per_stage = [{"w": w[s], "b": b[s]} for s in range(4)]
    assert torch.equal(gpipe(lambda p, h: torch.tanh(h @ p["w"] + p["b"]),
                             per_stage, xs, mesh=mesh, axis="stage"), got)
    assert bubble_fraction(8, 4) == 3 / 11


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_train_step_matches_reference(ref, arch):
    _, out = ref
    jcfg = dataclasses.replace(jconfigs.reduced_config(
        jconfigs.get_config(arch)), dtype="float32")
    cfg = dataclasses.replace(tconfigs.reduced_config(
        tconfigs.get_config(arch)), dtype="float32")
    js = jinit_state(jcfg, jax.random.PRNGKey(0), JTrain(total_steps=10,
                                                         warmup_steps=0))
    state = train_state_from_numpy(jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32) if x.dtype != np.int32
        else np.asarray(x), js), cfg, "cpu")
    par = _par((4, 2), seq_shard=True, attn_chunk_q=8, attn_chunk_k=8,
               logits_chunk=8, moe_local_dispatch=arch != "yi-6b")
    batch = {k: np.array(v) for k, v in jlm_batch(
        0, 0, batch=8, seq=16, vocab=cfg.vocab).items()}
    step = make_jitted_train_step(cfg, par, TrainConfig(total_steps=10,
                                                        warmup_steps=0))
    state, metrics = step(state, batch)
    np.testing.assert_allclose(float(metrics["loss"]),
                               out[f"train_{arch}_loss"], rtol=1e-5)
    got = {part: {jax.tree_util.keystr(p): v.float().numpy()
                  for p, v in jax.tree_util.tree_leaves_with_path(
                      params_tree(flat, cfg))}
           for part, flat in (("params",
                               dict(state["params"].named_parameters())),
                              ("m", state["opt"]["m"]))}
    want = {part: {k.split("/", 1)[1]: v for k, v in out.items()
                   if k.startswith(f"train_{arch}_{part}/")}
            for part in ("params", "m")}
    for part in ("params", "m"):
        assert got[part].keys() == want[part].keys()
    for k, w in want["params"].items():
        m = want["m"][k]
        # the first moment is 0.1 x the clipped grad
        np.testing.assert_allclose(got["m"][k], m, rtol=1e-5,
                                   atol=1e-6 * np.abs(m).max(), err_msg=k)
        # AdamW's first step moves an entry by lr g / (|g| + eps): where
        # |g| is within 100 eps, the grad's last bits decide the move
        steady = np.abs(m) >= 0.1 * 100 * 1e-8
        np.testing.assert_allclose(got["params"][k][steady], w[steady],
                                   rtol=1e-5, atol=1e-5 * np.abs(w).max(),
                                   err_msg=k)


def test_launch_train_devices_on_the_cpu():
    """``--devices 4`` trains on a 2 x 2 debug mesh in a subprocess;
    ``--coordinator`` still raises, naming why."""
    env = dict(os.environ, PYTHONPATH=_SRC)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "yi-6b", "--reduced", "--devices", "4", "--steps", "2", "--batch",
         "4", "--seq", "16", "--device", "cpu"], env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    final = [ln for ln in out.stdout.splitlines()
             if ln.startswith("final loss:")]
    assert final and np.isfinite(float(final[-1].split()[-1]))
    with pytest.raises(NotImplementedError, match="single controller"):
        launch_train.main(["--arch", "yi-6b", "--reduced", "--coordinator",
                           "localhost:1234", "--device", "cpu"])
