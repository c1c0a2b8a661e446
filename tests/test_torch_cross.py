"""Cross attention at the model level against ``repro`` on the CPU: to
projected image tokens (Llama-3.2-Vision) and to a bidirectional encoder
over stub audio frames (Whisper), reduced.

``decode_cross_attention`` against the prefill's cross attention of the
same rows (float32, rtol = atol = 1e-5); the configs' checks are
``arch_parity``'s (tolerances stated there); Whisper's training state,
its encoder included, through checkpoints of either package.
"""
import pytest

torch = pytest.importorskip("torch")

import arch_parity as parity  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

F32 = dict(rtol=1e-5, atol=1e-5)


def test_cross_attention_decode_matches_prefill():
    """``decode_cross_attention`` on the memory's K/V from
    ``self_attention(memory=...)`` equals the prefill's cross attention
    of the same query row: no RoPE, every memory position valid."""
    d, h, hkv, hd = 16, 4, 2, 4
    p = tattn.init_attn(torch.Generator().manual_seed(0), d, h, hkv, hd,
                        torch.float32, "cpu")
    x = torch.randn(2, 5, d, generator=torch.Generator().manual_seed(1))
    mem = torch.randn(2, 7, d, generator=torch.Generator().manual_seed(2))
    pos = torch.arange(5, dtype=torch.int32).expand(2, 5)
    out, mk, mv = tattn.self_attention(p, x, pos, n_heads=h, n_kv=hkv, hd=hd,
                                       rope_theta=1e4, causal=False,
                                       memory=mem, return_kv=True,
                                       chunk_q=2, chunk_k=3)
    for t in range(5):
        got = tattn.decode_cross_attention(p, x[:, t], {"k": mk, "v": mv},
                                           n_heads=h, n_kv=hkv, hd=hd)
        torch.testing.assert_close(got, out[:, t], **F32)


@pytest.fixture(scope="module", params=["llama-3.2-vision-11b",
                                        "whisper-small"])
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


def test_whisper_checkpoints_across_packages(tmp_path):
    parity.check_checkpoints("whisper-small", tmp_path)
