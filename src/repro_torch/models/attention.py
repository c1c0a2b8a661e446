"""Attention for the model zoo (one device).

Prefill: blockwise ("flash-style") attention as an online softmax over
KV chunks, in plain PyTorch: O(S * chunk) score memory, causal, GQA
grouping.  Decode: one token against a KV cache updated in place.

The arithmetic of ``repro.models.attention``: scores, softmax and the
probability-value product in float32 from the parameter-dtype q, k, v.
``flash_decode``'s sharded branch, the sliding-window ring buffer and
cross attention come with Slices E and F.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.common import apply_rope, dense_init, params_dict

_NEG = -1e30


# ----------------------------------------------------------------- params
def init_attn(gen: torch.Generator, d_model: int, n_heads: int, n_kv: int,
              hd: int, dtype=torch.bfloat16, device=None):
    return params_dict(
        wq=dense_init(gen, (d_model, n_heads * hd), 0, dtype=dtype,
                      device=device),
        wk=dense_init(gen, (d_model, n_kv * hd), 0, dtype=dtype,
                      device=device),
        wv=dense_init(gen, (d_model, n_kv * hd), 0, dtype=dtype,
                      device=device),
        wo=dense_init(gen, (n_heads * hd, d_model), 0, dtype=dtype,
                      device=device))


def _divisor_chunk(s: int, c: int) -> int:
    """The largest divisor of ``s`` that is at most ``c``."""
    for d in range(min(c, s), 0, -1):
        if s % d == 0:
            return d
    return 1


# ------------------------------------------------------------- blockwise
def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                        causal: bool, chunk_q: int = 512, chunk_k: int = 512
                        ) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Sk, Hkv, hd) -> (B, Sq, H, hd).

    Online softmax over KV chunks: per q chunk, running max ``m``, sum
    ``l`` and float32 accumulator over the KV chunks in order.
    """
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    cq = _divisor_chunk(sq, chunk_q)
    ck = _divisor_chunk(sk, chunk_k)
    scale = hd ** -0.5
    # (B, Hkv, G, Sq, hd) and (B, Hkv, Sk, hd), float32
    qg = q.reshape(b, sq, hkv, g, hd).permute(0, 2, 3, 1, 4).float()
    kc = k.permute(0, 2, 1, 3).float()
    vc = v.permute(0, 2, 1, 3).float()
    outs = []
    for qs in range(0, sq, cq):
        qc, qpos = qg[:, :, :, qs:qs + cq], q_pos[qs:qs + cq]
        m = torch.full((b, hkv, g, cq), _NEG, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, hkv, g, cq), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((b, hkv, g, cq, hd), dtype=torch.float32,
                          device=q.device)
        for ks in range(0, sk, ck):
            kk, vv = kc[:, :, ks:ks + ck], vc[:, :, ks:ks + ck]
            kpos = k_pos[ks:ks + ck]
            s = torch.einsum("bngqh,bnkh->bngqk", qc, kk) * scale
            mask = torch.ones((cq, ck), dtype=torch.bool, device=q.device)
            if causal:
                mask &= qpos[:, None] >= kpos[None, :]
            s = s.masked_fill(~mask, _NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bngqk,bnkh->bngqh", p, vv)
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.cat(outs, dim=3)                        # (B, Hkv, G, Sq, hd)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)
    return out.to(q.dtype)


def self_attention(params, x: torch.Tensor, positions: torch.Tensor, *,
                   n_heads: int, n_kv: int, hd: int, rope_theta: float,
                   causal: bool = True, chunk_q: int = 512,
                   chunk_k: int = 512, return_kv: bool = False):
    """Full block: project -> rope -> blockwise attention -> out-proj.
    With ``return_kv``, also returns the (post-rope) k, v for KV
    caches."""
    b, s, _ = x.shape
    q = (x @ params["wq"]).reshape(b, s, n_heads, hd)
    k = (x @ params["wk"]).reshape(b, s, n_kv, hd)
    v = (x @ params["wv"]).reshape(b, s, n_kv, hd)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    pos = positions[0] if positions.ndim > 1 else positions
    out = blockwise_attention(q, k, v, pos, pos, causal=causal,
                              chunk_q=chunk_q, chunk_k=chunk_k)
    out = out.reshape(b, s, n_heads * hd) @ params["wo"]
    if return_kv:
        return out, k, v
    return out


# --------------------------------------------------------------- decode
def _plain_decode(q, k_cache, v_cache, lengths):
    """q: (B, Hkv, G, hd); caches (B, S, Hkv, hd); lengths (B,) tokens
    valid.  Returns the partial softmax (m, l, o), float32."""
    b, s, hkv, hd = k_cache.shape
    scale = hd ** -0.5
    s_ = torch.einsum("bngh,bsnh->bngs", q.float(), k_cache.float()) * scale
    pos = torch.arange(s, dtype=torch.int32, device=q.device)
    valid = pos[None, :] < lengths[:, None]              # (B, S)
    s_ = s_.masked_fill(~valid[:, None, None, :], _NEG)
    m = s_.amax(dim=-1)
    p = torch.exp(s_ - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bngs,bsnh->bngh", p, v_cache.float())
    return m, l, o


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, lengths: torch.Tensor
                 ) -> torch.Tensor:
    """Single-token attention vs a KV cache on one device.

    q: (B, H, hd); caches: (B, S, Hkv, hd); lengths: (B,)."""
    b, h, hd = q.shape
    hkv = k_cache.shape[2]
    m, l, o = _plain_decode(q.reshape(b, hkv, h // hkv, hd), k_cache,
                            v_cache, lengths)
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, h, hd).to(q.dtype)


def decode_self_attention(params, x_tok: torch.Tensor, cache: dict,
                          lengths: torch.Tensor, *, n_heads: int, n_kv: int,
                          hd: int, rope_theta: float
                          ) -> Tuple[torch.Tensor, dict]:
    """One decode step.  x_tok: (B, D); cache: {"k","v"}: (B, S, Hkv, hd),
    written in place at each row's position ``lengths``.

    Returns (out (B, D), cache)."""
    b, _ = x_tok.shape
    q = (x_tok @ params["wq"]).reshape(b, 1, n_heads, hd)
    k = (x_tok @ params["wk"]).reshape(b, 1, n_kv, hd)
    v = (x_tok @ params["wv"]).reshape(b, 1, n_kv, hd)
    q = apply_rope(q, lengths[:, None], rope_theta)[:, 0]
    k = apply_rope(k, lengths[:, None], rope_theta)[:, 0]
    bidx = torch.arange(b, device=x_tok.device)
    slot = lengths.long()
    cache["k"][bidx, slot] = k.to(cache["k"].dtype)
    cache["v"][bidx, slot] = v[:, 0].to(cache["v"].dtype)
    out = flash_decode(q, cache["k"], cache["v"],
                       lengths + 1).reshape(b, n_heads * hd)
    return out.to(x_tok.dtype) @ params["wo"], cache
