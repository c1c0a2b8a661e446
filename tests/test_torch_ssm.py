"""The port's Mamba-1 and Mamba-2 blocks (``repro_torch.models.ssm``) and
the SSM configs (Falcon-Mamba, Zamba2 with its shared attention block,
reduced) against ``repro`` on the CPU.

The scans against the reference test's step-by-step recurrence
(``tests/test_models.py``'s oracles, rtol = atol = 2e-4) and against
``repro.models.ssm`` on the same numpy inputs: float32 at rtol = atol =
1e-5 (the chunk scan's additions run in another order than XLA's
``associative_scan``), grads at rtol 1e-4 with an atol of 1e-6 x the
largest entry.  The configs' checks are ``arch_parity``'s; Zamba2's
training state also goes through checkpoints of either package.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import arch_parity as parity  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

RNG = np.random.default_rng(0)
ORACLE = dict(rtol=2e-4, atol=2e-4)
F32 = dict(rtol=1e-5, atol=1e-5)


def _mamba1_inputs(b=2, s=32, di=8, n=4):
    x = RNG.normal(size=(b, s, di)).astype(np.float32)
    dt = np.abs(RNG.normal(size=(b, s, di))).astype(np.float32) * 0.1
    bm = RNG.normal(size=(b, s, n)).astype(np.float32)
    cm = RNG.normal(size=(b, s, n)).astype(np.float32)
    a = -np.abs(RNG.normal(size=(di, n))).astype(np.float32)
    h0 = RNG.normal(size=(b, di, n)).astype(np.float32)
    return x, dt, bm, cm, a, h0


def _ssd_inputs(b=2, s=32, nh=3, p=8, n=4):
    x = RNG.normal(size=(b, s, nh, p)).astype(np.float32)
    dt = np.abs(RNG.normal(size=(b, s, nh))).astype(np.float32) * 0.1
    bm = RNG.normal(size=(b, s, n)).astype(np.float32)
    cm = RNG.normal(size=(b, s, n)).astype(np.float32)
    a = -np.abs(RNG.normal(size=(nh,))).astype(np.float32)
    h0 = RNG.normal(size=(b, nh, p, n)).astype(np.float32)
    return x, dt, bm, cm, a, h0


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_mamba1_chunked_matches_sequential():
    """``tests/test_models.py``'s oracle on the port (h0 = 0)."""
    x, dt, bm, cm, a, _ = _mamba1_inputs()
    h0 = np.zeros((2, 8, 4), np.float32)
    y, hf = tssm.mamba1_scan(*_t((x, dt, bm, cm, a, h0)), chunk=8)
    h = h0.copy()
    ys = np.zeros_like(x)
    for t in range(x.shape[1]):
        h = np.exp(dt[:, t, :, None] * a) * h \
            + (dt[:, t] * x[:, t])[..., None] * bm[:, t, None, :]
        ys[:, t] = np.einsum("bdn,bn->bd", h, cm[:, t])
    np.testing.assert_allclose(y.numpy(), ys, **ORACLE)
    np.testing.assert_allclose(hf.numpy(), h, **ORACLE)


def test_ssd_chunked_matches_sequential():
    """``tests/test_models.py``'s oracle on the port (h0 = 0)."""
    x, dt, bm, cm, a, _ = _ssd_inputs()
    h0 = np.zeros((2, 3, 8, 4), np.float32)
    y, hf = tssm.ssd_scan(*_t((x, dt, bm, cm, a, h0)), chunk=8)
    h = h0.copy()
    ys = np.zeros_like(x)
    for t in range(x.shape[1]):
        decay = np.exp(dt[:, t] * a)
        upd = np.einsum("bhp,bn,bh->bhpn", x[:, t], bm[:, t], dt[:, t])
        h = h * decay[..., None, None] + upd
        ys[:, t] = np.einsum("bhpn,bn->bhp", h, cm[:, t])
    np.testing.assert_allclose(y.numpy(), ys, **ORACLE)
    np.testing.assert_allclose(hf.numpy(), h, **ORACLE)


@pytest.mark.parametrize("k", [1, 2, 5, 8, 64])
def test_linear_scan_is_the_recurrence(k):
    """The Hillis-Steele rounds at chunk lengths of 1, a power of two,
    and neither."""
    a = RNG.uniform(0.5, 1.0, size=(2, k, 3)).astype(np.float32)
    b = RNG.normal(size=(2, k, 3)).astype(np.float32)
    h = np.zeros((2, 3), np.float32)
    want = []
    for t in range(k):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    got = tssm.linear_scan(*_t((a, b)))
    np.testing.assert_allclose(got.numpy(), np.stack(want, 1), **F32)


@pytest.mark.parametrize("scan", ["mamba1", "ssd"])
@pytest.mark.parametrize("chunk,remat", [(8, False), (8, True), (5, False),
                                         (64, True)])
def test_scans_match_reference(scan, chunk, remat):
    """Outputs, final state and grads (w.r.t. every input, h0 included)
    against ``repro.models.ssm`` with a carried state; chunk 5 falls back
    to 4 (it must divide 32), 64 is one chunk."""
    inputs = _mamba1_inputs() if scan == "mamba1" else _ssd_inputs()
    jfn = jssm.mamba1_scan if scan == "mamba1" else jssm.ssd_scan
    tfn = tssm.mamba1_scan if scan == "mamba1" else tssm.ssd_scan
    w = RNG.normal(size=inputs[0].shape).astype(np.float32)
    wh = RNG.normal(size=inputs[-1].shape).astype(np.float32)

    def jloss(*args):
        y, hf = jfn(*args, chunk=chunk, remat=remat)
        return jnp.sum(y * w) + jnp.sum(hf * wh), (y, hf)
    (_, (jy, jh)), jg = jax.value_and_grad(
        jloss, argnums=tuple(range(6)), has_aux=True)(
            *map(jnp.asarray, inputs))
    ts = [t.requires_grad_(True) for t in _t(inputs)]
    y, hf = tfn(*ts, chunk=chunk, remat=remat)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **F32)
    np.testing.assert_allclose(hf.detach().numpy(), np.asarray(jh), **F32)
    loss = (y * torch.from_numpy(w)).sum() + (hf * torch.from_numpy(wh)).sum()
    for g, want in zip(torch.autograd.grad(loss, ts), jg):
        want = np.asarray(want)
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4,
                                   atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("s", [1, 2, 3, 7])
def test_conv_state_of_short_prompts(s):
    """A prefill of S < d_conv - 1 tokens leaves zeros before the first
    one in the conv window, which the step-by-step conv also sees."""
    c, k = 5, 4
    x = torch.from_numpy(RNG.normal(size=(2, s, c)).astype(np.float32))
    w = torch.from_numpy(RNG.normal(size=(k, c)).astype(np.float32))
    bias = torch.from_numpy(RNG.normal(size=(c,)).astype(np.float32))
    full = tssm.causal_conv(x, w, bias)
    state = torch.zeros((2, k - 1, c))
    for t in range(s):
        y, state = tssm.conv_step(x[:, t], state, w, bias)
        torch.testing.assert_close(y, full[:, t])
    torch.testing.assert_close(state, tssm.conv_tail(x, k))


@pytest.fixture(scope="module", params=["falcon-mamba-7b", "zamba2-1.2b"])
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


def test_zamba2_checkpoints_across_packages(tmp_path):
    """With the ``shared`` block, each shared layer's ``marker`` leaf and
    the tail."""
    parity.check_checkpoints("zamba2-1.2b", tmp_path)
