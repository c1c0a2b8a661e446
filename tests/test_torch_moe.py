"""The port's MoE layer (``repro_torch.models.moe``) and the MoE configs
(Granite-MoE, Llama-4 Maverick, reduced) against ``repro`` on the CPU.

``moe_apply`` on the same numpy weights and inputs in both packages
(float32: rtol 1e-5 with an atol of 1e-6 x the largest entry, since the
combine adds in another order); the dispatch against a numpy oracle of
the reference's documented semantics (a stable sort of the (token,
choice) pairs by expert, positions within each expert's group, the
capacity clamp), which both packages must match: the same pairs kept and
dropped at the configs' capacity factor 1.25.  The configs' checks are
``arch_parity``'s.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import arch_parity as parity  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

RNG = np.random.default_rng(0)
ATOL_SCALE = 1e-6


def _weights(d, f, e, seed=0):
    params = jmoe.init_moe(jax.random.PRNGKey(seed), d, f, e, jnp.float32)
    return params, {k: np.asarray(v) for k, v in params.items()}


def _port(np_params):
    from repro_torch.models.common import params_dict
    return params_dict(**{k: torch.from_numpy(v.copy())
                          for k, v in np_params.items()})


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.detach().numpy(), want, rtol=1e-5,
        atol=ATOL_SCALE * float(np.abs(want).max()))


def _oracle(np_params, x, top_k, cf, act="silu"):
    """The reference's semantics in float64 numpy, pair by pair: the
    kept (token, choice) pairs and the combined output."""
    e = np_params["router"].shape[1]
    xt = x.reshape(-1, x.shape[-1]).astype(np.float64)
    t = xt.shape[0]
    logits = xt @ np_params["router"].astype(np.float64)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    expert = np.argsort(-p, axis=-1, kind="stable")[:, :top_k]
    flat = expert.reshape(-1)
    order = np.argsort(flat, kind="stable")
    cap = int(cf * t * top_k / e) or 1
    seen = np.zeros(e, int)
    kept = set()
    for pair in order:
        ex = flat[pair]
        if seen[ex] < cap:
            kept.add(int(pair))
        seen[ex] += 1
    out = np.zeros_like(xt)
    for pair in kept:
        tok, ex = pair // top_k, flat[pair]
        h = xt[tok] @ np_params["wi"][ex]
        g = xt[tok] @ np_params["wg"][ex]
        h = (g / (1 + np.exp(-g))) * h if act == "silu" \
            else np.square(np.maximum(g, 0)) * h
        out[tok] += p[tok, ex] * (h @ np_params["wo"][ex])
    return kept, out.reshape(x.shape)


def test_moe_routes_all_tokens_with_high_capacity():
    """``tests/test_models.py``'s test on the port: shapes, finite, aux
    > 0, and the same outputs for the tokens in reverse order."""
    params, np_params = _weights(16, 32, 8)
    x = RNG.normal(size=(2, 8, 16)).astype(np.float32)
    p = _port(np_params)
    out, aux = tmoe.moe_apply(p, torch.from_numpy(x), top_k=2,
                              capacity_factor=8.0)
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    assert float(aux) > 0
    outp, _ = tmoe.moe_apply(p, torch.from_numpy(x[:, ::-1].copy()),
                             top_k=2, capacity_factor=8.0)
    np.testing.assert_allclose(outp.numpy()[:, ::-1], out.numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("act", ["silu", "relu2"])
@pytest.mark.parametrize("top_k,cf", [(1, 1.25), (2, 1.25), (2, 8.0),
                                      (4, 1.25), (2, 0.01)])
def test_moe_apply_matches_reference(top_k, cf, act):
    """Output and aux loss against ``repro``'s ``moe_apply`` and the
    numpy oracle; at 1.25 and below, pairs are dropped and the port drops
    the same ones (capacity 0.01 clamps to one slot an expert)."""
    d, f, e = 16, 24, 8
    params, np_params = _weights(d, f, e, seed=top_k)
    x = RNG.normal(size=(3, 10, d)).astype(np.float32)
    want, jaux = jmoe.moe_apply(params, jnp.asarray(x), top_k=top_k,
                                capacity_factor=cf, act=act)
    got, aux = tmoe.moe_apply(_port(np_params), torch.from_numpy(x),
                              top_k=top_k, capacity_factor=cf, act=act)
    _close(got, want)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    kept, oracle = _oracle(np_params, x, top_k, cf, act)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-4, atol=1e-5)
    probs = torch.softmax(torch.from_numpy(x.reshape(-1, d))
                          @ torch.from_numpy(np_params["router"].copy()), -1)
    cap = tmoe.capacity(30, top_k, e, cf)
    sg, stok, se, slot, expert = tmoe.dispatch(probs, top_k, cap)
    order = np.argsort(expert.reshape(-1).numpy(), kind="stable")
    mine = {int(order[i]) for i in range(len(order)) if slot[i] < e * cap}
    assert mine == kept
    if cf < 1:
        assert len(kept) == e                   # one pair an expert


def test_moe_dispatch_is_stable_across_ties():
    """Every token routed to one expert: the earliest tokens keep the
    slots, in token order, and the rest are dropped."""
    probs = torch.zeros((6, 4))
    probs[:, 2] = 0.7
    probs[:, 1] = 0.3
    sg, stok, se, slot, expert = tmoe.dispatch(probs, 1, 2)
    assert se.tolist() == [2] * 6
    assert stok.tolist() == list(range(6))
    assert slot.tolist() == [4, 5, 8, 8, 8, 8]      # expert 2: slots 4, 5
    assert torch.equal(sg, torch.full((6,), 0.7))


def test_moe_grads_match_reference():
    """Grads of sum(out * w) + aux w.r.t. x and every weight, float32
    (F1's rtol 1e-4, atol 1e-6 x each leaf's largest entry)."""
    d, f, e = 16, 24, 8
    params, np_params = _weights(d, f, e, seed=3)
    x = RNG.normal(size=(2, 6, d)).astype(np.float32)
    w = RNG.normal(size=(2, 6, d)).astype(np.float32)

    def jloss(p, xx):
        out, aux = jmoe.moe_apply(p, xx, top_k=2, capacity_factor=1.25)
        return jnp.sum(out * w) + aux
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    p = _port(np_params).requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = tmoe.moe_apply(p, tx, top_k=2, capacity_factor=1.25)
    loss = (out * torch.from_numpy(w)).sum() + aux
    names = list(p.keys())
    grads = torch.autograd.grad(loss, [p[k] for k in names] + [tx])
    for k, g in zip(names + ["x"], grads):
        want = np.asarray(jgx if k == "x" else jgp[k])
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4,
                                   atol=1e-6 * float(np.abs(want).max()),
                                   err_msg=k)


@pytest.fixture(scope="module", params=["granite-moe-1b-a400m",
                                        "llama4-maverick-400b-a17b"])
def case(request):
    return parity.Case(request.param)


def test_serving_matches_reference_float32(case):
    parity.check_serving(case)


def test_forward_train_grads_float32(case):
    parity.check_grads(case)


def test_remat_knobs_match_reference(case):
    """remat "block", attn_remat and ssm_remat on: the reference's
    grads (remat changes no value)."""
    parity.check_grads(case, "block", **parity.REMAT_KNOBS)


def test_probs_bf16_matches_reference(case):
    parity.check_grads(case, attn_probs_bf16=True)


def test_train_steps_match_reference(case):
    parity.check_train_steps(case)


def test_bfloat16_embeddings(case):
    parity.check_bfloat16(case)


@pytest.mark.parametrize("cf", [1.25, 4.0])
def test_moe_passes_match_reference(cf, monkeypatch):
    """The experts in passes of 1 and 3 experts (MAX_BUFFER cut to fit)
    give the reference's outputs and grads, as one pass does: cf 4.0 =
    E / top_k holds every token."""
    d, f, e, top_k = 16, 24, 8, 2
    params, np_params = _weights(d, f, e, seed=5)
    x = RNG.normal(size=(2, 9, d)).astype(np.float32)
    want, _ = jmoe.moe_apply(params, jnp.asarray(x), top_k=top_k,
                             capacity_factor=cf)
    cap = tmoe.capacity(18, top_k, e, cf)
    for per in (1, 3):
        monkeypatch.setattr(tmoe, "MAX_BUFFER", per * cap * max(d, f))
        p = _port(np_params).requires_grad_(True)
        got, aux = tmoe.moe_apply(p, torch.from_numpy(x), top_k=top_k,
                                  capacity_factor=cf)
        _close(got, want)
        got.sum().backward()
        assert all(w.grad is not None for w in p.values())
