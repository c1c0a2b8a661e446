"""The port's optimizer substrate (``repro_torch.optim``) on the CPU.

The four tests of ``tests/test_optim.py`` that apply to one device, run
on the port with their own tolerances (AdamW against numpy over 5 steps
at rtol 1e-5 / atol 1e-6; bf16 params with float32 moments; the clip;
the schedule's shape), and each function against ``repro.optim`` on the
same numpy inputs at rtol 1e-6: both compute in float32 in the same
order of operations, so they differ only where XLA and PyTorch round a
power, a cosine or a sum of squares differently.  The int8 error-feedback
all-reduce (``optim.compression``) on a one-shard mesh takes
``test_optim.py``'s unbiasedness test; ``tests/test_torch_mesh.py`` holds
it to the reference on eight shards.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.optim as jopt  # noqa: E402
from repro_torch.core.distributed import ShardMesh  # noqa: E402
from repro_torch.optim import (AdamWConfig, adamw_init,  # noqa: E402
                               adamw_update, apply_ef, clip_by_global_norm,
                               clip_by_global_norm_, global_norm, init_ef,
                               warmup_cosine)

REF = dict(rtol=1e-6, atol=1e-7)


def test_adamw_matches_numpy_reference():
    cfg = AdamWConfig(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(4, 3)).astype(np.float32)
    params = {"w": torch.from_numpy(p0.copy())}
    state = adamw_init(params)
    lr = 1e-2

    p_np, m_np, v_np = p0.copy(), np.zeros_like(p0), np.zeros_like(p0)
    for t in range(1, 6):
        g = rng.normal(size=p0.shape).astype(np.float32)
        params, state = adamw_update({"w": torch.from_numpy(g)}, state,
                                     params, lr, cfg)
        m_np = cfg.b1 * m_np + (1 - cfg.b1) * g
        v_np = cfg.b2 * v_np + (1 - cfg.b2) * g * g
        mh = m_np / (1 - cfg.b1 ** t)
        vh = v_np / (1 - cfg.b2 ** t)
        p_np = p_np - lr * (mh / (np.sqrt(vh) + cfg.eps)
                            + cfg.weight_decay * p_np)
        np.testing.assert_allclose(params["w"].numpy(), p_np,
                                   rtol=1e-5, atol=1e-6)
    assert int(state["step"]) == 5
    assert state["step"].dtype == torch.int32


def test_adamw_bf16_params_f32_moments():
    params = {"w": torch.ones((8,), dtype=torch.bfloat16)}
    state = adamw_init(params)
    assert state["m"]["w"].dtype == torch.float32
    g = {"w": torch.full((8,), 0.5, dtype=torch.bfloat16)}
    new_p, state = adamw_update(g, state, params, 0.1)
    assert new_p["w"].dtype == torch.bfloat16
    assert state["v"]["w"].dtype == torch.float32
    assert new_p["w"] is params["w"]              # updated in place
    assert float(new_p["w"][0]) < 1.0


def test_clip_by_global_norm():
    g = {"a": torch.full((10,), 3.0), "b": torch.full((6,), 4.0)}
    norm = float(global_norm(g))
    clipped, reported = clip_by_global_norm(g, 1.0)
    assert abs(float(reported) - norm) < 1e-5
    assert abs(float(global_norm(clipped)) - 1.0) < 1e-5
    # below threshold -> untouched
    small, _ = clip_by_global_norm(g, norm * 2)
    np.testing.assert_allclose(small["a"].numpy(), g["a"].numpy(), rtol=1e-6)
    # the pure form leaves its input alone; the in-place form replaces
    # the entries of the dict it is given
    assert float(g["a"][0]) == 3.0
    same, _ = clip_by_global_norm_(g, 1.0)
    assert same is g and abs(float(global_norm(g)) - 1.0) < 1e-5


def test_warmup_cosine_shape():
    lrs = [float(warmup_cosine(torch.tensor(s, dtype=torch.int32),
                               peak_lr=1.0, warmup_steps=10, total_steps=100))
           for s in range(0, 101, 5)]
    assert lrs[0] == 0.0
    assert abs(max(lrs) - 1.0) < 0.11
    assert lrs[-1] <= lrs[2]          # decayed below peak
    assert lrs[-1] >= 0.099           # min_ratio floor
    lr = warmup_cosine(torch.tensor(7, dtype=torch.int32), peak_lr=1.0,
                       warmup_steps=10, total_steps=100)
    assert lr.dtype == torch.float32 and lr.ndim == 0


# ------------------------------------------------- against repro.optim
@pytest.mark.parametrize("steps", [0, 1, 5, 9, 10, 11, 50, 99, 100, 130])
@pytest.mark.parametrize("warmup,total,min_ratio", [(10, 100, 0.1),
                                                    (0, 40, 0.0),
                                                    (3, 3, 0.25)])
def test_warmup_cosine_matches_reference(steps, warmup, total, min_ratio):
    kw = dict(peak_lr=3e-4, warmup_steps=warmup, total_steps=total,
              min_ratio=min_ratio)
    a = float(warmup_cosine(torch.tensor(steps, dtype=torch.int32), **kw))
    b = float(jopt.warmup_cosine(jnp.int32(steps), **kw))
    np.testing.assert_allclose(a, b, **REF)


def _grads(rng):
    shapes = {"embed": (16, 8), "blocks.0.attn.wq": (8, 8), "norm": (8,)}
    return {k: (rng.normal(size=s) * 0.3).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("max_norm", [0.5, 1.0, 100.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_matches_reference(max_norm, dtype):
    g = _grads(np.random.default_rng(1))
    tg = {k: torch.from_numpy(v).to(getattr(torch, dtype))
          for k, v in g.items()}
    jg = {k: jnp.asarray(v).astype(dtype) for k, v in g.items()}
    a, na = clip_by_global_norm(tg, max_norm)
    b, nb = jopt.clip_by_global_norm(jg, max_norm)
    np.testing.assert_allclose(float(na), float(nb), **REF)
    for k in g:
        assert a[k].dtype == tg[k].dtype
        np.testing.assert_allclose(
            a[k].float().numpy(), np.asarray(b[k].astype(jnp.float32)),
            **(REF if dtype == "float32" else dict(rtol=2 ** -7, atol=0)))


@pytest.mark.parametrize("lr_tensor", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference(dtype, lr_tensor):
    """5 updates from the same params and grads: params (float32; bf16
    within one bf16 ulp, a rounding apart) and float32 moments."""
    rng = np.random.default_rng(2)
    cfg = AdamWConfig(weight_decay=0.05)
    p0 = _grads(rng)
    # copies: the update works in place, and jnp.asarray may share the
    # numpy buffer
    tp = {k: torch.tensor(v).to(getattr(torch, dtype))
          for k, v in p0.items()}
    jp = {k: jnp.asarray(v).astype(dtype) for k, v in p0.items()}
    ts, js = adamw_init(tp), jopt.adamw_init(jp)
    jcfg = jopt.AdamWConfig(b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
                            weight_decay=cfg.weight_decay)
    for t in range(5):
        g = _grads(rng)
        lr = 1e-2 * (t + 1)
        tlr = torch.tensor(lr, dtype=torch.float32) if lr_tensor else lr
        jlr = jnp.float32(lr) if lr_tensor else lr
        tp, ts = adamw_update({k: torch.from_numpy(v).to(tp[k].dtype)
                               for k, v in g.items()}, ts, tp, tlr, cfg)
        jp, js = jopt.adamw_update({k: jnp.asarray(v).astype(dtype)
                                    for k, v in g.items()}, js, jp, jlr, jcfg)
    assert int(ts["step"]) == int(js["step"]) == 5
    ptol = REF if dtype == "float32" else dict(rtol=2 ** -7, atol=1e-6)
    for k in p0:
        np.testing.assert_allclose(tp[k].float().numpy(), np.asarray(
            jp[k].astype(jnp.float32)), **ptol)
        for mom in ("m", "v"):
            np.testing.assert_allclose(ts[mom][k].numpy(),
                                       np.asarray(js[mom][k]), **REF)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_large_leaves_update_a_slice_at_a_time(dtype, monkeypatch):
    """AdamW and the clip over a leaf above ``adamw.SLICE`` entries, a
    slice of rows at a time: AdamW's weights and moments equal one pass's
    bit for bit (elementwise updates); the clip's norm within float32
    rounding of the sum's order, each grad scaled by min(1, 1 / norm) as
    one pass scales it, the caller's grads left as they were."""
    from repro_torch.optim import adamw, clipping
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(37, 11, generator=gen).to(dtype),
              "b": torch.randn(5, generator=gen).to(dtype)}
    grads = {k: torch.randn(v.shape, generator=gen).to(dtype)
             for k, v in params.items()}
    outs = []
    for cut in (1 << 26, 40):
        monkeypatch.setattr(adamw, "SLICE", cut)
        assert len(adamw.slices(params["w"])) == (1 if cut > 407 else 13)
        p = {k: v.clone() for k, v in params.items()}
        opt = adamw_init(p)
        for _ in range(2):
            adamw_update(grads, opt, p, 1e-2)
        g = {k: v.clone() for k, v in grads.items()}
        clipped, norm = clipping.clip_by_global_norm(g, 1.0)
        assert all(torch.equal(g[k], grads[k]) for k in g)
        scale = torch.clamp(1.0 / norm, max=1.0)
        for k in g:
            assert torch.equal(clipped[k], (g[k].float() * scale).to(dtype))
        outs.append((norm, p, opt))
    (n1, p1, o1), (n2, p2, o2) = outs
    torch.testing.assert_close(n2, n1, rtol=1e-6, atol=0)
    for k in params:
        assert torch.equal(p1[k], p2[k])
        assert torch.equal(o1["m"][k], o2["m"][k])
        assert torch.equal(o1["v"][k], o2["v"][k])


def test_ef_quantizer_unbiased_over_steps():
    """``test_optim.py``'s error-feedback test on the port's ``apply_ef``
    (one shard: the pmax is the identity): the sum of 50 compressed
    updates converges to 50 x the true gradient."""
    rng = np.random.default_rng(1)
    g_true = torch.from_numpy(rng.normal(size=(256,)).astype(np.float32)
                              * 0.01)
    mesh = ShardMesh(["cpu"], "pod")
    ef = [init_ef({"g": g_true})]
    applied = torch.zeros_like(g_true)
    for _ in range(50):
        red, ef = apply_ef([{"g": g_true}], ef, mesh, "pod", 1)
        applied += red[0]["g"]
    total_err = float((applied - 50 * g_true).abs().max())
    assert total_err < 0.01 * float((50 * g_true).abs().max()) + 1e-4

