"""The port's model stack (``repro_torch.configs``, ``repro_torch.models``,
``repro_torch.serve.engine``, ``repro_torch.data.lm_batch``) against
``repro`` on the CPU.

The same numpy inputs go through both packages: weights from the
reference's ``init_params`` carried across as float32 numpy by
``interop.model_params_from_numpy`` (bf16 -> f32 -> bf16 is exact), and
tokens from the reference's ``lm_batch``.  Reduced ``yi-6b`` (silu) and
``nemotron-4-15b`` (relu2) configs, with three layers so that the
stacked ``(repeats, ...)`` leaves are unstacked in order.

Tolerances:
  * float32 configs: every output within rtol = atol = 1e-5 of the
    reference's, and generated tokens equal;
  * bf16 configs: embeddings with cosine >= 0.999 a row (both packages
    round each product to bf16, but accumulate in other orders), and the
    first greedy token equal wherever the reference's top-2 logit margin
    is above 1e-2 of its logit range;
  * functions alone (rmsnorm, RoPE, the MLP, blockwise attention) in
    float32 at 1e-5, and rmsnorm and RoPE in bf16 within one bf16 ulp
    (rtol 2**-7).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro.data import lm_batch as jlm_batch  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import decode_step as jdecode_step  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.models import prefill as jprefill  # noqa: E402
from repro.models.parallel import ParallelConfig as JPar  # noqa: E402
from repro.models.transformer import forward_embed as jforward_embed  # noqa: E402
from repro.serve import generate as jgenerate  # noqa: E402
from repro_torch.data import LMDataIterator, lm_batch  # noqa: E402
from repro_torch.interop import model_params_from_numpy  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models import (ParallelConfig, decode_step,  # noqa: E402
                                forward_embed, hidden_states, init_params,
                                prefill)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.transformer import check_ported  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.serve import generate  # noqa: E402

F32 = dict(rtol=1e-5, atol=1e-5)
BF16_COS = 0.999
MARGIN = 1e-2
JPAR = JPar(mesh=None, attn_chunk_q=4, attn_chunk_k=4, logits_chunk=8,
            remat="none")
TPAR = ParallelConfig(attn_chunk_q=4, attn_chunk_k=4, logits_chunk=8,
                      remat="none")
DENSE = ("yi-6b", "nemotron-4-15b")
RNG = np.random.default_rng(0)


def _cfgs(arch, dtype, layers=3):
    """(reference, port) reduced configs of ``arch`` with ``layers``
    layers in ``dtype``."""
    kw = dict(n_layers=layers, repeats=layers, dtype=dtype)
    j = dataclasses.replace(jconfigs.reduced_config(
        jconfigs.get_config(arch)), **kw)
    t = dataclasses.replace(tconfigs.reduced_config(
        tconfigs.get_config(arch)), **kw)
    return j, t


def _models(arch, dtype, layers=3):
    jc, tc = _cfgs(arch, dtype, layers)
    jp = jinit_params(jc, jax.random.PRNGKey(0))
    leaves = jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), jp)
    return jc, tc, jp, model_params_from_numpy(leaves, tc, "cpu")


def _tokens(cfg, b=3, s=12, seed=4):
    return np.array(jlm_batch(seed, 0, batch=b, seq=s, vocab=cfg.vocab,
                              cfg=cfg)["tokens"])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_configs_equal_the_reference(arch):
    j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(tconfigs.reduced_config(t)) == \
        dataclasses.asdict(jconfigs.reduced_config(j))
    assert t.num_params() == j.num_params()
    assert t.num_active_params() == j.num_active_params()
    assert t.param_dtype == getattr(torch, j.dtype)
    assert tconfigs.ARCH_NAMES == jconfigs.ARCH_NAMES
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    for shape in jconfigs.SHAPES.values():
        assert tconfigs.shape_applicable(t, shape) == \
            jconfigs.shape_applicable(j, shape)


def test_yi_6b_full_size():
    cfg = tconfigs.get_config("yi-6b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_ff, cfg.vocab) == (32, 4096, 32, 4, 11008, 64000)
    assert cfg.num_params() == 6_060_769_280
    assert cfg.param_dtype == torch.bfloat16
    with pytest.raises(KeyError):
        tconfigs.get_config("no-such-arch")


# -------------------------------------------------------------- functions
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_and_rope(dtype):
    x = RNG.normal(size=(2, 5, 3, 16)).astype(np.float32)
    w = RNG.normal(size=(16,)).astype(np.float32)
    pos = np.arange(5, dtype=np.int32)[None].repeat(2, 0) + 7
    tol = F32 if dtype == "float32" else dict(rtol=2 ** -7, atol=2 ** -7)
    jx, jw = (jnp.asarray(a).astype(dtype) for a in (x, w))
    tx, tw = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, w))
    a = jcommon.rmsnorm(jx, jw, 1e-5)
    b = tcommon.rmsnorm(tx, tw, 1e-5)
    assert b.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(b), _np(a), **tol)
    a = jcommon.apply_rope(jx, jnp.asarray(pos), 5e6)
    b = tcommon.apply_rope(tx, torch.from_numpy(pos), 5e6)
    np.testing.assert_allclose(_np(b), _np(a), **tol)


@pytest.mark.parametrize("act", ["silu", "relu2"])
def test_mlp_apply(act):
    p = {k: RNG.normal(size=s).astype(np.float32) / 4
         for k, s in (("wi", (16, 24)), ("wg", (16, 24)), ("wo", (24, 16)))}
    x = RNG.normal(size=(3, 16)).astype(np.float32)
    a = jcommon.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(x), act)
    b = tcommon.mlp_apply(tcommon.params_dict(
        **{k: torch.from_numpy(v) for k, v in p.items()}),
        torch.from_numpy(x), act)
    np.testing.assert_allclose(_np(b), _np(a), **F32)
    with pytest.raises(ValueError):
        tcommon.mlp_apply(tcommon.params_dict(
            **{k: torch.from_numpy(v) for k, v in p.items()}),
            torch.from_numpy(x), "gelu")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("heads,kv", [(4, 2), (4, 4), (4, 1)])
@pytest.mark.parametrize("chunk", [4, 5, 64])
def test_blockwise_attention(causal, heads, kv, chunk):
    """Chunked (4 divides 12; 5 falls back to 4; 64: one chunk) and
    GQA groups of 2, 1 and 4 query heads a KV head."""
    b, s, hd = 2, 12, 8
    q = RNG.normal(size=(b, s, heads, hd)).astype(np.float32)
    k = RNG.normal(size=(b, s, kv, hd)).astype(np.float32)
    v = RNG.normal(size=(b, s, kv, hd)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)
    a = jattn.blockwise_attention(*map(jnp.asarray, (q, k, v, pos, pos)),
                                  causal=causal, chunk_q=chunk,
                                  chunk_k=chunk)
    t = tattn.blockwise_attention(*map(torch.from_numpy, (q, k, v, pos, pos)),
                                  causal=causal, chunk_q=chunk,
                                  chunk_k=chunk)
    np.testing.assert_allclose(_np(t), _np(a), **F32)


# ------------------------------------------------------------------ model
@pytest.mark.parametrize("arch", DENSE)
def test_forward_embed_prefill_decode_float32(arch):
    jc, tc, jp, tp = _models(arch, "float32")
    toks = _tokens(jc)
    a = jforward_embed(jp, {"tokens": jnp.asarray(toks)}, jc, JPAR)
    b = forward_embed(tp, {"tokens": toks}, tc, TPAR)
    assert b.dtype == torch.float32 and b.shape == (3, tc.d_model)
    np.testing.assert_allclose(_np(b), _np(a), **F32)
    np.testing.assert_allclose(np.linalg.norm(_np(b), axis=1), 1.0,
                               rtol=1e-5)

    ha, ca, la = jprefill(jp, {"tokens": jnp.asarray(toks[:, :8])}, jc,
                          JPAR, cache_len=12)
    hb, cb, lb = prefill(tp, {"tokens": toks[:, :8]}, tc, TPAR, cache_len=12)
    np.testing.assert_allclose(_np(hb), _np(ha), **F32)
    np.testing.assert_array_equal(lb.numpy(), np.asarray(la))
    assert len(cb["blocks"]) == tc.n_layers
    for i, c in enumerate(cb["blocks"]):
        for key in ("k", "v"):
            ref = np.asarray(ca["blocks"][0][key][i])
            np.testing.assert_allclose(c[key].numpy(), ref, **F32)
    for t in range(8, 12):
        ha, ca = jdecode_step(jp, ca, jnp.asarray(toks[:, t]), la, jc, JPAR)
        cb_before = cb
        hb, cb = decode_step(tp, cb, torch.from_numpy(toks[:, t]), lb, tc,
                             TPAR)
        assert cb is cb_before           # updated in place
        la, lb = la + 1, lb + 1
        np.testing.assert_allclose(_np(hb), _np(ha), **F32)


@pytest.mark.parametrize("arch", DENSE)
def test_generate_float32_tokens_equal(arch):
    jc, tc, jp, tp = _models(arch, "float32")
    toks = _tokens(jc, b=2, s=8)
    a = jgenerate(jp, {"tokens": jnp.asarray(toks)}, jc, JPAR, cache_len=16,
                  max_new_tokens=6)
    b = generate(tp, {"tokens": toks}, tc, TPAR, cache_len=16,
                 max_new_tokens=6, device="cpu")
    assert b.dtype == torch.int32 and b.shape == (2, 6)
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # eos on every row after the first token: one column
    first = int(b[0, 0])
    if bool((b[:, 0] == first).all()):
        assert generate(tp, {"tokens": toks}, tc, TPAR, cache_len=16,
                        max_new_tokens=6, eos_id=first,
                        device="cpu").shape == (2, 1)


@pytest.mark.parametrize("arch", DENSE)
def test_bfloat16_embeddings_and_first_token(arch):
    jc, tc, jp, tp = _models(arch, "bfloat16")
    toks = _tokens(jc, b=8, s=12)
    a = _np(jforward_embed(jp, {"tokens": jnp.asarray(toks)}, jc, JPAR))
    b = _np(forward_embed(tp, {"tokens": toks}, tc, TPAR))
    cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                            * np.linalg.norm(b, axis=1))
    assert cos.min() >= BF16_COS, cos
    # the first greedy token, where the reference's margin allows
    ha, _, _ = jprefill(jp, {"tokens": jnp.asarray(toks)}, jc, JPAR, 16)
    logits = _np(ha) @ np.asarray(jp["lm_head"], np.float32).T
    top2 = np.sort(logits, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > MARGIN * np.ptp(logits, axis=1)
    assert clear.sum() >= 4, clear
    out = generate(tp, {"tokens": toks}, tc, TPAR, cache_len=16,
                   max_new_tokens=1, device="cpu")[:, 0].numpy()
    np.testing.assert_array_equal(out[clear], logits.argmax(1)[clear])


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_prefill(arch):
    """h_last from prefill(seq[:t]) + decode steps == prefill(seq): the
    port's own KV-cache test (the reference's ``test_models.py``
    decode-against-prefill test, on the port's weights)."""
    _, tc = _cfgs(arch, "float32")
    params = init_params(tc, seed=1, device="cpu")
    b, s_total, s_prompt = 2, 12, 8
    toks = torch.randint(0, tc.vocab, (b, s_total),
                         generator=torch.Generator().manual_seed(1))
    h, caches, lengths = prefill(params, {"tokens": toks[:, :s_prompt]}, tc,
                                 TPAR, cache_len=s_total)
    for t in range(s_prompt, s_total):
        h, caches = decode_step(params, caches, toks[:, t],
                                torch.full((b,), t, dtype=torch.int32), tc,
                                TPAR)
    h_ref, _, _ = prefill(params, {"tokens": toks}, tc, TPAR,
                          cache_len=s_total)
    torch.testing.assert_close(h, h_ref, rtol=2e-3, atol=2e-3)
    # and the last hidden state is prefill's last row of hidden_states
    hs = hidden_states(params, {"tokens": toks}, tc, TPAR)
    torch.testing.assert_close(hs[:, -1], h_ref, **F32)


def test_init_params_shapes_and_scale():
    """The port's own draws: the reference's leaf shapes and dtypes, a
    fan-in truncated normal (|w| <= 2 std), deterministic in the seed."""
    jc, tc = _cfgs("yi-6b", "bfloat16", layers=2)
    p = init_params(tc, seed=3, device="cpu")
    ref = jax.eval_shape(lambda: jinit_params(jc, jax.random.PRNGKey(0)))
    assert tuple(p.embed.shape) == ref["embed"].shape
    assert tuple(p.lm_head.shape) == ref["lm_head"].shape
    assert len(p.blocks) == tc.n_layers
    for lp in p.blocks:
        for group in ("attn", "mlp"):
            for k, w in getattr(lp, group).items():
                want = ref["blocks"][0][group][k]
                assert tuple(w.shape) == want.shape[1:], (group, k)
                assert w.dtype == torch.bfloat16 and not w.requires_grad
                std = 1.0 / np.sqrt(w.shape[0])
                assert float(w.float().abs().max()) <= 2 * std * 1.01
                assert abs(float(w.float().std()) / std - 0.88) < 0.1
        assert bool((lp.norm1 == 1).all()) and bool((lp.norm2 == 1).all())
    q = init_params(tc, seed=3, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(p.parameters(),
                                                 q.parameters()))
    r = init_params(tc, seed=4, device="cpu")
    assert not torch.equal(p.embed, r.embed)
    assert p.nbytes() == 2 * tc.num_params() + 2 * tc.d_model * (
        2 * tc.n_layers + 1)                     # + the norms


@pytest.mark.parametrize("arch", [a for a in jconfigs.ARCH_NAMES
                                  if a not in DENSE + ("mistral-nemo-12b",)])
def test_init_params_has_the_reference_leaves(arch):
    """Every layer kind's ``init_params``: the reference's leaf shapes and
    dtypes (the router and the SSM's A_log, D and dt_bias float32 in a
    bf16 model), through ``train.params_tree``'s layout."""
    from repro_torch.train.step import params_tree
    jc = jconfigs.reduced_config(jconfigs.get_config(arch))
    tc = tconfigs.reduced_config(tconfigs.get_config(arch))
    p = init_params(tc, seed=0, device="cpu")
    ref = jax.eval_shape(lambda: jinit_params(jc, jax.random.PRNGKey(0)))
    want = {jax.tree_util.keystr(k): (v.shape, str(v.dtype))
            for k, v in jax.tree_util.tree_leaves_with_path(ref)}
    got = {jax.tree_util.keystr(k): (tuple(v.shape),
                                     str(v.dtype).split(".")[-1])
           for k, v in jax.tree_util.tree_leaves_with_path(
               params_tree(dict(p.named_parameters()), tc))}
    assert got == want
    assert not any(w.requires_grad for w in p.parameters())


def test_device_defaults_to_the_gpu():
    _, tc = _cfgs("yi-6b", "float32", layers=1)
    params = init_params(tc, device="cpu")
    toks = {"tokens": np.zeros((1, 4), np.int32)}
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the defaults run there")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(tc)
    with pytest.raises(RuntimeError, match="CUDA"):
        generate(params, toks, tc, TPAR, cache_len=8, max_new_tokens=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm_batch(0, 0, batch=1, seq=4, vocab=8)
    with pytest.raises(TypeError, match="ShardMesh"):
        ParallelConfig(mesh=object())


def test_lm_batch_contract():
    a = lm_batch(5, 2, batch=3, seq=7, vocab=50, device="cpu")
    assert a["tokens"].shape == (3, 7) and a["tokens"].dtype == torch.int32
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < 50
    b = lm_batch(5, 2, batch=3, seq=7, vocab=50, device="cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], lm_batch(
        5, 3, batch=3, seq=7, vocab=50, device="cpu")["tokens"])
    it = LMDataIterator(seed=5, batch=3, seq=7, vocab=50, device="cpu")
    first = [next(it)["tokens"] for _ in range(3)]
    resumed = LMDataIterator(seed=5, batch=3, seq=7, vocab=50, device="cpu")
    resumed.load_state_dict({"step": 2, "seed": 5})
    assert torch.equal(next(resumed)["tokens"], first[2])
    assert torch.equal(first[2], lm_batch(5, 2, batch=3, seq=7, vocab=50,
                                          device="cpu")["tokens"])
    with pytest.raises(ValueError):
        resumed.load_state_dict({"step": 0, "seed": 6})


@pytest.mark.parametrize("arch", ["whisper-small", "llama-3.2-vision-11b"])
def test_lm_batch_carries_stub_inputs(arch):
    """An audio or vision config's batch also carries stub frames or
    image embeddings of the reference's shapes and dtype (bf16, standard
    normal), deterministic in (seed, step), and so does the iterator's;
    a dense config's batch has tokens and labels only."""
    cfg = tconfigs.get_config(arch)
    jcfg = jconfigs.get_config(arch)
    key = "frames" if cfg.encoder_layers else "image_embeds"
    ref = jax.eval_shape(lambda: jlm_batch(0, 0, batch=2, seq=4,
                                           vocab=cfg.vocab, cfg=jcfg))
    a = lm_batch(0, 0, batch=2, seq=4, vocab=cfg.vocab, cfg=cfg,
                 device="cpu")
    assert set(a) == set(ref) == {"tokens", "labels", key}
    assert tuple(a[key].shape) == ref[key].shape == (2, 1536, cfg.d_model)
    assert a[key].dtype == torch.bfloat16 and str(ref[key].dtype) == \
        "bfloat16"
    x = a[key].float()
    assert abs(float(x.mean())) < 0.01 and abs(float(x.std()) - 1) < 0.01
    b = next(LMDataIterator(seed=0, batch=2, seq=4, vocab=cfg.vocab,
                            cfg=cfg, device="cpu"))
    assert torch.equal(a[key], b[key]) and torch.equal(a["tokens"],
                                                       b["tokens"])
    assert not torch.equal(a[key], lm_batch(0, 1, batch=2, seq=4,
                                            vocab=cfg.vocab, cfg=cfg,
                                            device="cpu")[key])
    dense = tconfigs.get_config("yi-6b")
    assert set(lm_batch(0, 0, batch=1, seq=4, vocab=8, cfg=dense,
                        device="cpu")) == {"tokens", "labels"}


def test_model_parallel_knobs_raise():
    """A mesh that is not a ``ShardMesh`` raises where it is made; a
    debug mesh and the per-shard MoE dispatch (which the reference takes
    only under a mesh) are accepted, as are the single-device knobs."""
    with pytest.raises(TypeError, match="ShardMesh"):
        ParallelConfig(mesh=object())
    assert not ParallelConfig(moe_local_dispatch=True).active
    mesh = make_debug_mesh((2, 2), device="cpu")
    par = ParallelConfig(mesh=mesh, moe_local_dispatch=True)
    assert par.active and par.mesh is mesh and par.n_model == 2
    par = ParallelConfig(attn_remat=True, attn_probs_bf16=True,
                         ssm_remat=True)
    assert (par.attn_remat, par.attn_probs_bf16, par.ssm_remat) == \
        (True, True, True)
    for arch in tconfigs.ARCH_NAMES:
        check_ported(tconfigs.get_config(arch))
    bad = dataclasses.replace(tconfigs.get_config("yi-6b"),
                              pattern=("conv",), repeats=32)
    with pytest.raises(ValueError, match="unknown layer kind"):
        check_ported(bad)
