"""Training on the port's dense path (``repro_torch.models.forward_train``,
``repro_torch.train``, ``repro_torch.launch.train`` and ``roofline``)
against ``repro`` on the CPU.

The same numpy inputs go through both packages: the reference's
``init_state`` carried across as float32 numpy by
``interop.train_state_from_numpy`` (bf16 -> f32 -> bf16 is exact) and
the reference's ``lm_batch`` tokens.  Reduced configs with two layers, so
that the stacked ``(repeats, ...)`` leaves are unstacked in order.

Tolerances, stated where they are used:
  * the loss (``softmax_xent``, ``forward_train``): float32 rtol 1e-5;
  * each grad leaf of ``forward_train``: float32 rtol 1e-4, and an atol of
    1e-6 x the leaf's largest entry (sums in another order);
  * 5 train steps, float32: loss, grad_norm and lr at rtol 1e-5 each
    step; the final weights and moments at rtol 1e-5 with an atol of
    1e-5 x the leaf's largest entry (AdamW divides by sqrt(v), so an
    entry whose grad is near 0 moves by a share of lr that the last
    bits of that grad decide); bf16: loss within 2e-2 relative each
    step, the weights at cosine >= 0.999 a leaf;
  * the loop's crash and resume: the final loss at rtol 1e-4 (the
    reference test's).
"""
import dataclasses
import logging
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.data import lm_batch as jlm_batch  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro.models import embedding as jemb  # noqa: E402
from repro.models import forward_train as jforward_train  # noqa: E402
from repro.models.parallel import ParallelConfig as JPar  # noqa: E402
from repro.train import LoopConfig as JLoop  # noqa: E402
from repro.train import TrainConfig as JTrain  # noqa: E402
from repro.train import init_state as jinit_state  # noqa: E402
from repro.train import make_train_step as jmake_train_step  # noqa: E402
from repro.train import train_loop as jtrain_loop  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.data import lm_batch  # noqa: E402
from repro_torch.interop import (model_params_from_numpy,  # noqa: E402
                                 train_state_from_numpy)
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import (ParallelConfig, decode_step,  # noqa: E402
                                forward_embed, forward_train, init_params,
                                prefill)
from repro_torch.models import embedding as temb  # noqa: E402
from repro_torch.train import (LoopConfig, TrainConfig,  # noqa: E402
                               init_state, load_state_tree, make_train_step,
                               state_tree, train_loop)
from repro_torch.train.step import params_tree  # noqa: E402

DENSE = ("yi-6b", "mistral-nemo-12b", "nemotron-4-15b")
F32 = dict(rtol=1e-5, atol=1e-6)
BF16_COS = 0.999
RNG = np.random.default_rng(0)


def _cfgs(arch, dtype, layers=2):
    kw = dict(n_layers=layers, repeats=layers, dtype=dtype)
    return (dataclasses.replace(jconfigs.reduced_config(
        jconfigs.get_config(arch)), **kw),
        dataclasses.replace(tconfigs.reduced_config(
            tconfigs.get_config(arch)), **kw))


def _pars(remat, chunk=4, logits=4):
    kw = dict(attn_chunk_q=chunk, attn_chunk_k=chunk, logits_chunk=logits,
              remat=remat)
    return JPar(mesh=None, **kw), ParallelConfig(**kw)


def _np(x):
    """A leaf of either package as a float32 (or int) numpy array."""
    if isinstance(x, torch.Tensor):
        return x.numpy() if x.dtype == torch.int32 else x.float().numpy()
    x = jnp.asarray(x)
    return np.asarray(x if x.dtype == jnp.int32 else x.astype(jnp.float32))


def _leaves(tree):
    return {jax.tree_util.keystr(p): _np(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _states(arch, dtype, layers=2):
    """(reference config, port config, reference state, port state) on
    the reference's weights."""
    jc, tc = _cfgs(arch, dtype, layers)
    js = jinit_state(jc, jax.random.PRNGKey(0))
    return jc, tc, js, train_state_from_numpy(
        jax.tree_util.tree_map(_np, js), tc, "cpu")


def _batch(cfg, step, b=4, s=8, seed=3):
    return {k: np.array(v) for k, v in jlm_batch(
        seed, step, batch=b, seq=s, vocab=cfg.vocab).items()}


def _assert_trees_close(a, b, rtol, scale):
    """Two trees in the reference's layout, leaf for leaf: rtol, and an
    atol of ``scale`` x each leaf's largest entry."""
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        atol = scale * float(np.max(np.abs(lb[k]), initial=0.0))
        np.testing.assert_allclose(la[k], lb[k], rtol=rtol, atol=atol,
                                   err_msg=k)


# --------------------------------------------------------------- the loss
@pytest.mark.parametrize("chunk", [1, 4, 12])
def test_softmax_xent_value_and_grad(chunk):
    b, s, d, v = 2, 12, 16, 40
    head = RNG.normal(size=(v, d)).astype(np.float32)
    h = RNG.normal(size=(b, s, d)).astype(np.float32)
    labels = RNG.integers(0, v, (b, s)).astype(np.int32)
    labels[0, :5] = -1                       # ignored
    labels[1, 7] = -1

    def jloss(hd, hh):
        return jemb.softmax_xent(hd, hh, jnp.asarray(labels), None,
                                 chunk=chunk)
    ja, (jgh, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(head), jnp.asarray(h))
    th = torch.from_numpy(head).requires_grad_(True)
    tx = torch.from_numpy(h).requires_grad_(True)
    ta = temb.softmax_xent(th, tx, torch.from_numpy(labels).long(),
                           chunk=chunk)
    tgh, tgx = torch.autograd.grad(ta, (th, tx))
    assert ta.dtype == torch.float32 and ta.ndim == 0
    np.testing.assert_allclose(float(ta.detach()), float(ja), rtol=1e-5)
    np.testing.assert_allclose(tgh.numpy(), np.asarray(jgh), **F32)
    np.testing.assert_allclose(tgx.numpy(), np.asarray(jgx), **F32)


def test_softmax_xent_edges():
    head = torch.zeros((5, 4))
    h = torch.zeros((1, 6, 4))
    with pytest.raises(ValueError, match="chunk"):
        temb.softmax_xent(head, h, torch.zeros((1, 6), dtype=torch.long),
                          chunk=4)
    # every label ignored: the count clamps at 1 and the loss is 0
    loss = temb.softmax_xent(head, h, torch.full((1, 6), -1), chunk=3)
    assert float(loss) == 0.0


# ----------------------------------------------------------- forward_train
@pytest.mark.parametrize("remat", ["none", "block"])
@pytest.mark.parametrize("arch", DENSE)
def test_forward_train_and_grads_float32(arch, remat):
    """Loss at rtol 1e-5, each grad leaf at rtol 1e-4 (atol 1e-6 x its
    largest entry), mapped through the stacking (``params_tree``)."""
    jc, tc, js, ts = _states(arch, "float32")
    jpar, tpar = _pars(remat)
    batch = _batch(jc, 0)
    batch["labels"][0, :3] = -1
    (ja, jm), jg = jax.value_and_grad(
        lambda p: jforward_train(p, {k: jnp.asarray(v) for k, v in
                                     batch.items()}, jc, jpar),
        has_aux=True)(js["params"])
    model = ts["params"]
    ta, tm = forward_train(model, batch, tc, tpar)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(ta, [p for _, p in model.named_parameters()])
    np.testing.assert_allclose(float(ta.detach()), float(ja), rtol=1e-5)
    np.testing.assert_allclose(float(tm["ce_loss"].detach()),
                               float(jm["ce_loss"]),
                               rtol=1e-5)
    assert float(tm["aux_loss"]) == float(jm["aux_loss"]) == 0.0
    _assert_trees_close(params_tree(dict(zip(names, grads)), tc), jg,
                        rtol=1e-4, scale=1e-6)


# ---------------------------------------------------------- the train step
@pytest.mark.parametrize("dtype,remat,microbatch", [
    ("float32", "none", 1), ("float32", "block", 1),
    ("float32", "none", 2), ("float32", "block", 2),
    ("bfloat16", "none", 1), ("bfloat16", "block", 2)])
def test_train_step_matches_reference(dtype, remat, microbatch):
    jc, tc, js, ts = _states("yi-6b", dtype)
    jpar, tpar = _pars(remat)
    kw = dict(peak_lr=1e-3, warmup_steps=2, total_steps=5,
              microbatch=microbatch)
    jstep = jax.jit(jmake_train_step(jc, jpar, JTrain(**kw)))
    tstep = make_train_step(tc, tpar, TrainConfig(**kw))
    for i in range(5):
        batch = _batch(jc, i)
        js, jm = jstep(js, batch)
        ts, tm = tstep(ts, batch)
        assert set(tm) == set(jm)
        for k in ("loss", "grad_norm", "lr"):
            assert tm[k].dtype == torch.float32 and tm[k].ndim == 0
            if dtype == "float32":
                np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                           rtol=1e-5, err_msg=(i, k))
        if dtype == "bfloat16":
            assert abs(float(tm["loss"]) / float(jm["loss"]) - 1) < 2e-2
            np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                       rtol=1e-6)
    assert int(ts["opt"]["step"]) == int(js["opt"]["step"]) == 5
    if dtype == "float32":
        _assert_trees_close(state_tree(ts, tc), js, rtol=1e-5, scale=1e-5)
        return
    la, lb = _leaves(state_tree(ts, tc)["params"]), _leaves(js["params"])
    for k in la:
        cos = float((la[k] * lb[k]).sum() / (np.linalg.norm(la[k])
                                            * np.linalg.norm(lb[k])))
        assert cos >= BF16_COS, (k, cos)


@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_reduced_train_step(arch):
    """``test_arch_smoke.test_reduced_train_step`` on the port, every
    layer kind: one optimizer step (with the config's stub frames or
    image embeddings), loss and grad norm finite, params update, shapes
    and dtypes kept; an MoE config's aux loss above 0."""
    cfg = tconfigs.reduced_config(tconfigs.get_config(arch))
    state = init_state(cfg, 0, device="cpu")
    before = {k: v.detach().clone()
              for k, v in state["params"].named_parameters()}
    step = make_train_step(cfg, _pars("block", 8, 8)[1],
                           TrainConfig(total_steps=10, warmup_steps=0))
    batch = lm_batch(0, 0, batch=2, seq=16, vocab=cfg.vocab, cfg=cfg,
                     device="cpu")
    new_state, metrics = step(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    assert (float(metrics["aux_loss"]) > 0) == (cfg.moe is not None)
    after = dict(new_state["params"].named_parameters())
    assert any(not torch.equal(after[k].detach(), v)
               for k, v in before.items())
    for k, v in before.items():
        assert after[k].shape == v.shape and after[k].dtype == v.dtype
        assert after[k].requires_grad


def test_serving_builds_no_graph():
    """Serving stays free of gradients: a module ``init_params`` built
    makes no autograd graph in ``forward_embed``, ``prefill`` or
    ``decode_step``; a training state's weights require grad."""
    cfg = tconfigs.reduced_config(tconfigs.get_config("yi-6b"))
    par = _pars("block")[1]
    params = init_params(cfg, 0, device="cpu")
    assert not any(p.requires_grad for p in params.parameters())
    toks = {"tokens": np.zeros((2, 8), np.int32)}
    assert not forward_embed(params, toks, cfg, par).requires_grad
    h, caches, lengths = prefill(params, toks, cfg, par, cache_len=12)
    assert not h.requires_grad
    assert not any(c[k].requires_grad for c in caches["blocks"]
                   for k in ("k", "v"))
    h2, _ = decode_step(params, caches, torch.zeros(2, dtype=torch.int32),
                        lengths, cfg, par)
    assert not h2.requires_grad
    state = init_state(cfg, 0, device="cpu")
    assert all(p.requires_grad for p in state["params"].parameters())


# ---------------------------------------------------------------- the loop
PAR = ParallelConfig(mesh=None, attn_chunk_q=16, attn_chunk_k=16,
                     logits_chunk=16, remat="none")
TCFG = TrainConfig(peak_lr=1e-3, warmup_steps=2, total_steps=12)


def _loop(ckpt_dir, steps=12, **kw):
    cfg = tconfigs.reduced_config(tconfigs.get_config("yi-6b"))
    return train_loop(
        cfg, PAR, batch=2, seq=16, tcfg=TCFG,
        lcfg=LoopConfig(steps=steps, ckpt_every=4, log_every=1,
                        ckpt_dir=ckpt_dir), device="cpu", **kw)


class _CrashAt:
    def __init__(self, step):
        self.step = step

    def __call__(self, step):
        if step == self.step:
            raise RuntimeError(f"injected failure at step {step}")


def test_crash_restart_matches_uninterrupted(tmp_path):
    """``test_fault``'s scenario on the port: kill at step 7, relaunch,
    final loss == one uninterrupted run (rtol 1e-4)."""
    hist_ref = _loop(str(tmp_path / "a"))
    d2 = str(tmp_path / "b")
    with pytest.raises(RuntimeError, match="injected"):
        _loop(d2, failure_injector=_CrashAt(7))
    assert CheckpointManager(d2).committed_steps() == [4]
    hist_resumed = _loop(d2)               # same command, resumes at 4
    assert hist_resumed["step"] == list(range(4, 12))
    assert hist_resumed["step"][-1] == hist_ref["step"][-1]
    np.testing.assert_allclose(hist_resumed["loss"][-1],
                               hist_ref["loss"][-1], rtol=1e-4)


class _DelayAt:
    """Delay step ``step`` by the reference test's 0.35 s, or by 10 x the
    median gap between the earlier steps' calls where that is longer (a
    loaded CPU), so that the delay is a straggler's by construction."""

    def __init__(self, step):
        self.step, self.calls = step, []

    def __call__(self, step):
        self.calls.append(time.perf_counter())
        if step != self.step:
            return 0.0
        return max(0.35, 10 * float(np.median(np.diff(self.calls[:-1]))))


def test_straggler_watchdog_fires():
    hist = _loop(None, steps=10, step_delay_injector=_DelayAt(8))
    assert any(s[0] == 8 for s in hist["stragglers"]), hist["stragglers"]


def test_loss_decreases():
    hist = _loop(None, steps=12)
    assert hist["loss"][-1] < hist["loss"][0]


def test_loop_runs_on_the_gpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_loop(tconfigs.reduced_config(tconfigs.get_config("yi-6b")),
                   PAR, batch=2, seq=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_state(tconfigs.reduced_config(tconfigs.get_config("yi-6b")))


# ---------------------------------------------------- checkpoints, both ways
def _ref_loop(ckpt_dir, steps):
    jc = jconfigs.reduced_config(jconfigs.get_config("yi-6b"))
    jpar = JPar(mesh=None, attn_chunk_q=16, attn_chunk_k=16,
                logits_chunk=16, remat="none")
    return jtrain_loop(jc, jpar, batch=2, seq=16,
                       tcfg=JTrain(peak_lr=1e-3, warmup_steps=2,
                                   total_steps=12),
                       lcfg=JLoop(steps=steps, ckpt_every=4, log_every=1,
                                  ckpt_dir=ckpt_dir))


def _templates():
    jc = jconfigs.reduced_config(jconfigs.get_config("yi-6b"))
    tc = tconfigs.reduced_config(tconfigs.get_config("yi-6b"))
    data = {"step": 0, "seed": 0}
    return ({"state": jinit_state(jc, jax.random.PRNGKey(0)), "data": data},
            {"state": state_tree(init_state(tc, 0, device="cpu"), tc),
             "data": data}, tc)


def test_reference_checkpoints_resume_on_the_port(tmp_path):
    """The reference's loop saves steps 4 and 8; the port restores each,
    equal leaf for leaf to the reference's own restore, and its loop
    resumes from step 8 to the end."""
    d = str(tmp_path / "ck")
    _ref_loop(d, steps=8)
    jtemplate, ttemplate, tc = _templates()
    assert CheckpointManager(d).committed_steps() == [4, 8]
    for step in (4, 8):
        ref, _ = JManager(d).restore(jtemplate, step=step)
        got, s = CheckpointManager(d).restore(ttemplate, step=step,
                                              device="cpu")
        assert s == step and int(got["data"]["step"]) == step
        la, lb = _leaves(got["state"]), _leaves(ref["state"])
        assert la.keys() == lb.keys()
        for k in la:
            np.testing.assert_array_equal(la[k], lb[k], err_msg=k)
        state = load_state_tree(init_state(tc, 1, device="cpu"),
                                got["state"], tc)
        assert state["params"].embed.dtype == torch.bfloat16
        for k, v in _leaves(state_tree(state, tc)).items():
            np.testing.assert_array_equal(v, lb[k], err_msg=k)
    hist = _loop(d)
    assert hist["step"] == list(range(8, 12))
    assert all(np.isfinite(hist["loss"]))
    assert CheckpointManager(d).latest_step() == 12


def test_port_checkpoint_resumes_on_the_reference(tmp_path):
    """The port's loop saves step 4; ``repro.checkpoint`` restores it
    equal leaf for leaf to the port's state, and the reference's loop
    resumes from it."""
    d = str(tmp_path / "ck")
    tc = tconfigs.reduced_config(tconfigs.get_config("yi-6b"))
    cfg_loop = LoopConfig(steps=4, ckpt_every=4, log_every=1, ckpt_dir=d)
    train_loop(tc, PAR, batch=2, seq=16, tcfg=TCFG, lcfg=cfg_loop,
               device="cpu")
    jtemplate, ttemplate, _ = _templates()
    ref, step = JManager(d).restore(jtemplate)
    mine, _ = CheckpointManager(d).restore(ttemplate, device="cpu")
    assert step == 4 and int(ref["data"]["step"]) == 4
    assert ref["state"]["params"]["embed"].dtype == jnp.bfloat16
    la, lb = _leaves(mine["state"]), _leaves(ref["state"])
    assert la.keys() == lb.keys()
    for k in la:
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)
    hist = _ref_loop(d, steps=6)
    assert hist["step"] == [4, 5] and all(np.isfinite(hist["loss"]))


def test_state_tree_round_trip_on_three_layers():
    """Unstacking and stacking agree for layers 0, 1, 2 of one pattern
    position: the reference's numpy state, carried in and out again."""
    jc, tc, js, ts = _states("yi-6b", "float32", layers=3)
    assert len(ts["params"].blocks) == 3
    np.testing.assert_array_equal(
        ts["params"].blocks[2].attn["wq"].detach().numpy(),
        _np(js["params"]["blocks"][0]["attn"]["wq"][2]))
    a, b = _leaves(state_tree(ts, tc)), _leaves(js)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    model = model_params_from_numpy(jax.tree_util.tree_map(
        _np, js["params"]), tc, "cpu")
    assert not any(p.requires_grad for p in model.parameters())


# ---------------------------------------------------------------- launcher
def test_launch_train_main_on_the_cpu(tmp_path, caplog):
    d = str(tmp_path / "ck")
    argv = ["--arch", "yi-6b", "--reduced", "--batch", "2", "--seq", "16",
            "--ckpt-every", "2", "--ckpt-dir", d, "--device", "cpu"]
    with caplog.at_level(logging.INFO, logger="repro_torch.train"):
        hist = launch_train.main(argv + ["--steps", "3"])
        assert hist["step"][-1] == 2 and np.isfinite(hist["loss"][-1])
        hist = launch_train.main(argv + ["--steps", "5"])
    assert "restored checkpoint at step 3" in caplog.text
    assert hist["step"][-1] == 4
    # --devices 4: resumes step 5 and trains on a 2 x 2 debug mesh
    with caplog.at_level(logging.INFO, logger="repro_torch.train"):
        hist = launch_train.main(argv + ["--steps", "6", "--devices", "4"])
    assert hist["step"] == [5] and np.isfinite(hist["loss"][-1])
    assert "restored checkpoint at step 5" in caplog.text
    with pytest.raises(NotImplementedError, match="single controller"):
        launch_train.main(argv + ["--coordinator", "localhost:1234"])


# ---------------------------------------------------------------- roofline
HLO = """
  %ar = bf16[16,512,128]{2,1,0} all-reduce(bf16[16,512,128] %x), replica_groups={}
  %ag = (f32[8,64]{1,0}, s32[4]{0}) all-gather-start(f32[2,64] %y), dimensions={0}
  %rs = f32[1024]{0} reduce-scatter(f32[4096] %z), dimensions={0}
  %a2a = u8[3,5]{1,0} all-to-all(u8[3,5] %w), dimensions={0}
  %cp = s8[7]{0} collective-permute(s8[7] %v), source_target_pairs={{0,1}}
  %other = f32[9]{0} add(f32[9] %p, f32[9] %q)
"""


def test_roofline_matches_reference():
    assert roofline.collective_bytes(HLO) == jroof.collective_bytes(HLO)
    for args in ((100, 349900, 254), (64, 8192, 4096, 2)):
        assert roofline.linear_scan_traffic(*args) == \
            jroof.linear_scan_traffic(*args)
    for args in ((100, 4096, 254), (32, 1024, 54, 4)):
        assert roofline.lsh_scan_traffic(*args) == \
            jroof.lsh_scan_traffic(*args)
    for arch in ("yi-6b", "granite-moe-1b-a400m"):
        for shape in tconfigs.SHAPES.values():
            assert roofline.model_flops(tconfigs.get_config(arch), shape) == \
                jroof.model_flops(jconfigs.get_config(arch),
                                  jconfigs.SHAPES[shape.name])
    # the hardware model is the H100 SXM5's, and the one chip_smoke reads
    assert roofline.PEAK_FLOPS_BF16 == 989e12 and roofline.HBM_BW == 3.35e12
    assert roofline.PEAKS["sxm"] == (roofline.HBM_BW, roofline.PEAK_FLOPS_FP32,
                                     roofline.PEAK_FLOPS_TF32,
                                     roofline.PEAK_FLOPS_BF16)
    import chip_smoke
    assert chip_smoke.PEAKS is roofline.PEAKS
    terms = roofline.terms_from_cost({"flops": 989e12, "bytes accessed":
                                      3.35e12}, 450e9, 989e12, 1)
    assert terms.compute_s == terms.memory_s == terms.collective_s == 1.0
