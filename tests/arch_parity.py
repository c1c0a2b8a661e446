"""The port's layer kinds against ``repro`` on the CPU: the checks that
``test_torch_archs.py``, ``test_torch_cross.py``, ``test_torch_moe.py``
and ``test_torch_ssm.py`` run on their configs.

Each ``Case`` is one reduced config (``reduced_config``: one repeat of
the block pattern plus the tail, d_model 64) in float32, the reference's
``init_params`` weights carried across by
``interop.model_params_from_numpy``, and one numpy batch (3 x 12 tokens,
stub frames or image embeddings drawn standard normal) that both
packages take.  The reference's functions run under ``jax.jit``, each
compiled once a case (the module-scoped fixtures build a case once).

Tolerances:
  * serving (``forward_embed``, ``prefill`` with its caches, 4
    ``decode_step`` s): rtol = atol = 1e-5 (``test_torch_models``'s
    float32 bound); the MoE configs add an atol of 1e-6 x the largest
    entry (their float32 combine adds in another order);
  * ``forward_train``: ``ce_loss`` and ``aux_loss`` at rtol 1e-5, each
    grad leaf at rtol 1e-4 with an atol of 2e-6 x its largest entry:
    twice ``test_torch_train``'s 1e-6, since these configs stack 5 to 8
    layers (its 2) and a grad entry that is a long sum of cancelling
    terms rounds by more (on reduced Zamba2 one entry of 8,192 is
    2.8e-7 off against the 2.0e-7 of 1e-6 x its leaf's largest entry);
    with ``attn_probs_bf16`` each grad leaf within 2 ** -8 (a bf16 ulp)
    of the reference's in norm: a probability whose float32 value lies
    within the packages' float32 difference of a bf16 rounding boundary
    rounds to the neighbouring bf16 value in one of them;
  * 3 train steps: loss, grad norm, lr, ce_loss and aux_loss at rtol
    1e-5 each step; each final leaf (weights and moments) within 1e-4 of
    the reference's in norm, ||a - c|| <= 1e-4 ||c||
    (``torch_cases.TRAIN_RTOL``'s rule, not entry by entry): AdamW moves
    an entry by about lr whatever its grad's size, so an entry whose
    grads lie near eps or nearly cancel over the steps ends up apart by
    a share of lr that the last bits of those grads decide (one conv
    bias entry of reduced Zamba2, 2.8e-8 off against a 1.5e-8 atol; 2 of
    196,608 expert entries of reduced Maverick, whose combine adds in
    another order, 7.6e-6 off against 1.8e-6);
  * bf16 weights: embeddings at cosine >= 0.999 a row.
"""
import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.models import decode_step as jdecode_step
from repro.models import forward_train as jforward_train
from repro.models import init_params as jinit_params
from repro.models import prefill as jprefill
from repro.models.parallel import ParallelConfig as JPar
from repro.models.transformer import forward_embed as jforward_embed
from repro.checkpoint import CheckpointManager as JManager
from repro.train import LoopConfig as JLoop
from repro.train import TrainConfig as JTrain
from repro.train import init_state as jinit_state
from repro.train import make_train_step as jmake_train_step
from repro.train import train_loop as jtrain_loop
from repro_torch.checkpoint import CheckpointManager
from repro_torch.interop import model_params_from_numpy, train_state_from_numpy
from repro_torch.models import (ParallelConfig, decode_step, forward_embed,
                                forward_train, prefill)
from repro_torch.train import (LoopConfig, TrainConfig, init_state,
                               load_state_tree, make_train_step, state_tree,
                               train_loop)
from repro_torch.train.step import params_tree

F32 = dict(rtol=1e-5, atol=1e-5)
MOE_SCALE = 1e-6
GRAD_RTOL, GRAD_SCALE = 1e-4, 2e-6
BF16_ULP = 2.0 ** -8
STATE_RTOL = 1e-4
BF16_COS = 0.999
B, S, PROMPT = 3, 12, 8
REMAT_KNOBS = dict(attn_remat=True, ssm_remat=True)


def pars(remat="none", **knobs):
    kw = dict(attn_chunk_q=4, attn_chunk_k=4, logits_chunk=4, remat=remat,
              **knobs)
    return JPar(mesh=None, **kw), ParallelConfig(**kw)


def cfgs(arch, dtype="float32", **changes):
    """(reference, port) reduced configs of ``arch`` in ``dtype``."""
    j = dataclasses.replace(jconfigs.reduced_config(
        jconfigs.get_config(arch)), dtype=dtype, **changes)
    t = dataclasses.replace(tconfigs.reduced_config(
        tconfigs.get_config(arch)), dtype=dtype, **changes)
    return j, t


def np32(x):
    """A leaf of either package as float32 (or int32) numpy."""
    if isinstance(x, torch.Tensor):
        return x.numpy() if x.dtype == torch.int32 else \
            x.detach().float().numpy()
    x = jnp.asarray(x)
    return np.asarray(x if x.dtype == jnp.int32 else x.astype(jnp.float32))


def leaves(tree):
    return {jax.tree_util.keystr(p): np32(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def assert_trees_close(a, b, rtol, scale):
    """Two trees in the reference's layout, leaf for leaf: rtol, and an
    atol of ``scale`` x each leaf's largest entry."""
    la, lb = leaves(a), leaves(b)
    assert la.keys() == lb.keys(), set(la) ^ set(lb)
    for k in la:
        atol = scale * float(np.max(np.abs(lb[k]), initial=0.0))
        np.testing.assert_allclose(la[k], lb[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def make_batch(cfg, seed=0, b=B, s=S):
    """Numpy tokens, next-token labels and the config's stub inputs."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.encoder_layers:
        out["frames"] = rng.normal(
            size=(b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.num_image_tokens:
        out["image_embeds"] = rng.normal(
            size=(b, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    return out


def jx(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def ref_cache(caches, cfg, i):
    """Layer ``i``'s decode cache (execution order) of the reference's
    stacked caches, as numpy."""
    n, r = len(cfg.pattern), cfg.n_repeats
    c = (caches["blocks"][i % n] if i < n * r
         else caches["tail"][i - n * r])
    return {k: np32(v[i // n] if i < n * r else v) for k, v in c.items()}


class Case:
    """One reduced float32 config on the reference's weights."""

    def __init__(self, arch, **changes):
        self.arch = arch
        self.jc, self.tc = cfgs(arch, **changes)
        self.jp = jinit_params(self.jc, jax.random.PRNGKey(0))
        self.np = jax.tree_util.tree_map(np32, self.jp)
        self.batch = make_batch(self.jc)
        self.moe = self.jc.moe is not None
        self.cache = {}

    def model(self):
        return model_params_from_numpy(self.np, self.tc, "cpu")

    def close(self, got, want, what):
        atol = F32["atol"]
        if self.moe:
            atol = max(atol, MOE_SCALE * float(np.abs(want).max()))
        np.testing.assert_allclose(np32(got), np32(want), rtol=F32["rtol"],
                                   atol=atol, err_msg=f"{self.arch} {what}")


def check_serving(case: Case):
    """forward_embed, prefill (its h and every cache leaf) and 4 decode
    steps against the reference."""
    jc, tc = case.jc, case.tc
    jpar, tpar = pars()
    model = case.model()
    serve = {k: v for k, v in case.batch.items() if k != "labels"}
    a = jax.jit(lambda p, b: jforward_embed(p, b, jc, jpar))(case.jp,
                                                             jx(serve))
    b = forward_embed(model, serve, tc, tpar)
    assert b.shape == (B, tc.d_model) and b.dtype == torch.float32
    case.close(b, a, "forward_embed")
    prompt = dict(serve, tokens=serve["tokens"][:, :PROMPT])
    ha, ca, la = jax.jit(lambda p, b: jprefill(p, b, jc, jpar, S))(
        case.jp, jx(prompt))
    hb, cb, lb = prefill(model, prompt, tc, tpar, cache_len=S)
    case.close(hb, ha, "prefill h")
    np.testing.assert_array_equal(lb.numpy(), np.asarray(la))
    assert len(cb["blocks"]) == tc.n_layers
    for i, c in enumerate(cb["blocks"]):
        ref = ref_cache(ca, jc, i)
        assert c.keys() == ref.keys(), (i, c.keys(), ref.keys())
        for key in c:
            assert c[key].dtype == (torch.float32 if key == "ssm"
                                    else tc.param_dtype)
            case.close(c[key], ref[key], f"layer {i} cache {key}")
    step = jax.jit(lambda p, c, t, l: jdecode_step(p, c, t, l, jc, jpar))
    for t in range(PROMPT, S):
        tok = serve["tokens"][:, t]
        ha, ca = step(case.jp, ca, jnp.asarray(tok), la)
        hb, cb2 = decode_step(model, cb, torch.from_numpy(tok), lb, tc,
                              tpar)
        assert cb2 is cb                      # updated in place
        la, lb = la + 1, lb + 1
        case.close(hb, ha, f"decode h at {t}")


def port_grads(model, batch, tc, tpar):
    """(loss, metrics, grads as the reference's tree) of forward_train."""
    model.requires_grad_(True)
    loss, m = forward_train(model, batch, tc, tpar)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in
                                       model.named_parameters()],
                                allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g for n, g, p in
             zip(names, grads, model.parameters())}
    return loss, m, params_tree(grads, tc)


def ref_grads(case: Case, probs_bf16=False):
    """``jax.value_and_grad`` of the reference's forward_train, once a
    case and ``probs_bf16``: ((loss, metrics), grads).  Remat changes no
    value, so the port's remat knobs are held to the same grads."""
    key = ("grads", probs_bf16)
    if key not in case.cache:
        jpar, _ = pars(attn_probs_bf16=probs_bf16)
        jb = jx(case.batch)
        case.cache[key] = jax.jit(jax.value_and_grad(
            lambda p: jforward_train(p, jb, case.jc, jpar),
            has_aux=True))(case.jp)
    return case.cache[key]


def check_grads(case: Case, remat="none", **knobs):
    """forward_train's losses and every grad leaf with ``remat`` and
    ``knobs`` against ``jax.value_and_grad`` of the reference's (with the
    same ``attn_probs_bf16``)."""
    tc = case.tc
    _, tpar = pars(remat, **knobs)
    (ja, jm), jg = ref_grads(case, knobs.get("attn_probs_bf16", False))
    ta, tm, tg = port_grads(case.model(), case.batch, tc, tpar)
    for k, want in (("loss", ja), ("ce_loss", jm["ce_loss"]),
                    ("aux_loss", jm["aux_loss"])):
        got = ta if k == "loss" else tm[k]
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-5, err_msg=f"{case.arch} {k}")
    if case.moe:
        assert float(tm["aux_loss"]) > 0
    if not knobs.get("attn_probs_bf16"):
        assert_trees_close(tg, jg, rtol=GRAD_RTOL, scale=GRAD_SCALE)
        return
    la, lb = leaves(tg), leaves(jg)
    assert la.keys() == lb.keys()
    for k in la:
        assert np.linalg.norm(la[k] - lb[k]) <= \
            BF16_ULP * np.linalg.norm(lb[k]), (case.arch, k)


def check_train_steps(case: Case, steps=3):
    """``steps`` steps of make_train_step against the reference's jitted
    step on the same batches: metrics each step, the final state."""
    jc, tc = case.jc, case.tc
    jpar, tpar = pars("block")
    kw = dict(peak_lr=1e-3, warmup_steps=1, total_steps=steps)
    js = jinit_state(jc, jax.random.PRNGKey(0))
    ts = train_state_from_numpy(jax.tree_util.tree_map(np32, js), tc, "cpu")
    jstep = jax.jit(jmake_train_step(jc, jpar, JTrain(**kw)))
    tstep = make_train_step(tc, tpar, TrainConfig(**kw))
    for i in range(steps):
        batch = make_batch(jc, seed=10 + i)
        js, jm = jstep(js, jx(batch))
        ts, tm = tstep(ts, batch)
        assert set(tm) == set(jm)
        for k in ("loss", "grad_norm", "lr", "ce_loss", "aux_loss"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"{case.arch} step {i} {k}")
    assert int(ts["opt"]["step"]) == int(js["opt"]["step"]) == steps
    la, lb = leaves(state_tree(ts, tc)), leaves(js)
    assert la.keys() == lb.keys(), set(la) ^ set(lb)
    for k in la:
        assert np.linalg.norm(la[k] - lb[k]) <= \
            STATE_RTOL * np.linalg.norm(lb[k]), (case.arch, k)


def check_bfloat16(case: Case):
    """bf16 weights: forward_embed rows at cosine >= BF16_COS."""
    jc, tc = cfgs(case.arch, "bfloat16")
    jpar, tpar = pars()
    jp = jinit_params(jc, jax.random.PRNGKey(0))
    model = model_params_from_numpy(jax.tree_util.tree_map(np32, jp), tc,
                                    "cpu")
    assert model.embed.dtype == torch.bfloat16
    serve = {k: v for k, v in make_batch(jc, b=8).items() if k != "labels"}
    a = np32(jax.jit(lambda p, b: jforward_embed(p, b, jc, jpar))(
        jp, jx(serve)))
    b = np32(forward_embed(model, serve, tc, tpar))
    cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                            * np.linalg.norm(b, axis=1))
    assert cos.min() >= BF16_COS, (case.arch, cos)


def check_checkpoints(arch, tmp_path):
    """A reduced bf16 training state through the reference's layout and
    the checkpoints of either package: ``state_tree`` / ``load_state_tree``
    round-trip leaf for leaf with the reference's tree structure, shapes
    and dtypes; the reference's ``train_loop`` saves step 2, the port
    restores it equal leaf for leaf to the reference's own restore and
    resumes to step 3; the port's loop saves step 2 and the reference's
    restores it equal to the port's and resumes."""
    jc = jconfigs.reduced_config(jconfigs.get_config(arch))
    tc = tconfigs.reduced_config(tconfigs.get_config(arch))
    jstate = jinit_state(jc, jax.random.PRNGKey(0))
    tree = state_tree(init_state(tc, 0, device="cpu"), tc)
    ref_shapes = {jax.tree_util.keystr(p): (v.shape, str(v.dtype))
                  for p, v in jax.tree_util.tree_leaves_with_path(jstate)}
    shapes = {jax.tree_util.keystr(p): (tuple(v.shape),
                                        str(v.dtype).split(".")[-1])
              for p, v in jax.tree_util.tree_leaves_with_path(tree)}
    assert shapes == ref_shapes
    again = state_tree(load_state_tree(init_state(tc, 1, device="cpu"),
                                       tree, tc), tc)
    a, b = leaves(again), leaves(tree)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    jpar, tpar = pars()
    kw = dict(peak_lr=1e-3, warmup_steps=1, total_steps=4)
    template = {"step": 0, "seed": 0}

    def ref_loop(d, steps):
        return jtrain_loop(jc, jpar, batch=2, seq=8, tcfg=JTrain(**kw),
                           lcfg=JLoop(steps=steps, ckpt_every=2, log_every=1,
                                      ckpt_dir=d))

    def port_loop(d, steps):
        return train_loop(tc, tpar, batch=2, seq=8, tcfg=TrainConfig(**kw),
                          lcfg=LoopConfig(steps=steps, ckpt_every=2,
                                          log_every=1, ckpt_dir=d),
                          device="cpu")

    for first, second in ((ref_loop, port_loop), (port_loop, ref_loop)):
        d = str(tmp_path / first.__name__)
        first(d, 2)
        ref, step = JManager(d).restore({"state": jstate, "data": template},
                                        step=2)
        mine, step2 = CheckpointManager(d).restore(
            {"state": tree, "data": template}, step=2, device="cpu")
        assert step == step2 == 2 and int(mine["data"]["step"]) == 2
        la, lb = leaves(mine["state"]), leaves(ref["state"])
        assert la.keys() == lb.keys()
        for k in la:
            np.testing.assert_array_equal(la[k], lb[k], err_msg=k)
        hist = second(d, 3)
        assert hist["step"] == [2] and np.isfinite(hist["loss"]).all()
