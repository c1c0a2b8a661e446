"""Attention for the model zoo.

Prefill: blockwise ("flash-style") attention as an online softmax over
KV chunks, in plain PyTorch: O(S * chunk) score memory, causal,
sliding-window and cross attention with GQA grouping.  Decode: one
token against a KV cache updated in place (a ring buffer of the window
for sliding-window layers), or against a cross-attention memory's
static K/V.

The arithmetic of ``repro.models.attention``: scores, softmax and the
probability-value product in float32 from the parameter-dtype q, k, v
(``probs_bf16`` rounds the probabilities to bf16 before the product).
Under a mesh, ``flash_decode`` shards the cache's sequence over
``par.decode_seq_shard`` (a partial softmax a shard, merged by
log-sum-exp through the mesh).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

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


def attn_specs(par, stacked: bool = True):
    return {"wq": par.w_col(stacked), "wk": par.w_col(stacked),
            "wv": par.w_col(stacked), "wo": par.w_row(stacked)}


def _divisor_chunk(s: int, c: int) -> int:
    """The largest divisor of ``s`` that is at most ``c``."""
    for d in range(min(c, s), 0, -1):
        if s % d == 0:
            return d
    return 1


# ------------------------------------------------------------- blockwise
def _q_chunk(qc, qpos, kc, vc, k_pos, ck: int, causal: bool, window: int,
             probs_bf16: bool):
    """One q chunk (B, Hkv, G, cq, hd) against every KV chunk in order:
    running max ``m``, sum ``l`` and float32 accumulator."""
    b, hkv, g, cq, hd = qc.shape
    scale = hd ** -0.5
    m = torch.full((b, hkv, g, cq), _NEG, dtype=torch.float32,
                   device=qc.device)
    l = torch.zeros((b, hkv, g, cq), dtype=torch.float32, device=qc.device)
    acc = torch.zeros((b, hkv, g, cq, hd), dtype=torch.float32,
                      device=qc.device)
    for ks in range(0, kc.shape[2], ck):
        kk, vv = kc[:, :, ks:ks + ck], vc[:, :, ks:ks + ck]
        kpos = k_pos[ks:ks + ck]
        s = torch.einsum("bngqh,bnkh->bngqk", qc, kk) * scale
        mask = torch.ones((cq, kk.shape[2]), dtype=torch.bool,
                          device=qc.device)
        if causal:
            mask &= qpos[:, None] >= kpos[None, :]
        if window:
            mask &= (qpos[:, None] - kpos[None, :]) < window
        s = s.masked_fill(~mask, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        if probs_bf16:
            p = p.to(torch.bfloat16).float()
        acc = acc * corr[..., None] + torch.einsum("bngqk,bnkh->bngqh", p, vv)
        m = m_new
    return acc / torch.clamp(l, min=1e-30)[..., None]


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                        causal: bool, window: int = 0, chunk_q: int = 512,
                        chunk_k: int = 512, remat_qchunk: bool = False,
                        probs_bf16: bool = False) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Sk, Hkv, hd) -> (B, Sq, H, hd).

    Online softmax over KV chunks.  ``window``: a query attends to keys
    less than ``window`` positions before it.  ``remat_qchunk``: each q
    chunk runs under ``torch.utils.checkpoint``, so that the backward
    pass recomputes its KV loop instead of keeping its probabilities.
    ``probs_bf16``: the probabilities are rounded to bf16 before the
    p @ v product (m and l stay float32).
    """
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    cq = _divisor_chunk(sq, chunk_q)
    ck = _divisor_chunk(sk, chunk_k)
    # (B, Hkv, G, Sq, hd) and (B, Hkv, Sk, hd), float32
    qg = q.reshape(b, sq, hkv, g, hd).permute(0, 2, 3, 1, 4).float()
    kc = k.permute(0, 2, 1, 3).float()
    vc = v.permute(0, 2, 1, 3).float()
    outs = []
    for qs in range(0, sq, cq):
        args = (qg[:, :, :, qs:qs + cq], q_pos[qs:qs + cq], kc, vc, k_pos,
                ck, causal, window, probs_bf16)
        outs.append(checkpoint(_q_chunk, *args, use_reentrant=False)
                    if remat_qchunk else _q_chunk(*args))
    out = torch.cat(outs, dim=3)                        # (B, Hkv, G, Sq, hd)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)
    return out.to(q.dtype)


def self_attention(params, x: torch.Tensor, positions: torch.Tensor, *,
                   n_heads: int, n_kv: int, hd: int, rope_theta: float,
                   causal: bool = True, window: int = 0, chunk_q: int = 512,
                   chunk_k: int = 512, memory: Optional[torch.Tensor] = None,
                   return_kv: bool = False, remat_qchunk: bool = False,
                   probs_bf16: bool = False):
    """Full block: project -> rope -> blockwise attention -> out-proj.

    With ``memory`` (B, Sk, D), k and v come from it (cross attention:
    no RoPE on q or k, key positions ``arange(Sk)``).  With
    ``return_kv``, also returns the (post-rope) k, v for KV caches."""
    b, s, _ = x.shape
    q = (x @ params["wq"]).reshape(b, s, n_heads, hd)
    src = x if memory is None else memory
    sk = src.shape[1]
    k = (src @ params["wk"]).reshape(b, sk, n_kv, hd)
    v = (src @ params["wv"]).reshape(b, sk, n_kv, hd)
    q_pos = positions[0] if positions.ndim > 1 else positions
    if memory is None:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
        k_pos = q_pos
    else:
        k_pos = torch.arange(sk, dtype=torch.int32, device=x.device)
    out = blockwise_attention(q, k, v, q_pos, k_pos, causal=causal,
                              window=window, chunk_q=chunk_q,
                              chunk_k=chunk_k, remat_qchunk=remat_qchunk,
                              probs_bf16=probs_bf16)
    out = out.reshape(b, s, n_heads * hd) @ params["wo"]
    if return_kv:
        return out, k, v
    return out


# --------------------------------------------------------------- decode
def _plain_decode(q, k_cache, v_cache, lengths, seq_offset: int = 0):
    """q: (B, Hkv, G, hd); caches (B, S, Hkv, hd) holding positions
    ``seq_offset`` .. ``seq_offset + S - 1``; lengths (B,) tokens valid.
    Returns the partial softmax (m, l, o), float32."""
    b, s, hkv, hd = k_cache.shape
    scale = hd ** -0.5
    s_ = torch.einsum("bngh,bsnh->bngs", q.float(), k_cache.float()) * scale
    pos = seq_offset + torch.arange(s, dtype=torch.int32, device=q.device)
    valid = pos[None, :] < lengths[:, None]              # (B, S)
    s_ = s_.masked_fill(~valid[:, None, None, :], _NEG)
    m = s_.amax(dim=-1)
    p = torch.exp(s_ - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bngs,bsnh->bngh", p, v_cache.float())
    return m, l, o


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, lengths: torch.Tensor, par=None, *,
                 seq_axes: Tuple[str, ...] = ()) -> torch.Tensor:
    """Single-token attention vs a (possibly seq-sharded) KV cache.

    q: (B, H, hd); caches: (B, S, Hkv, hd); lengths: (B,).  ``seq_axes``:
    mesh axes sharding the cache's S dim.  Each shard (rank r over
    ``seq_axes``, row-major) computes the partial softmax of its S / n
    positions from ``r * S / n``; the parts merge by log-sum-exp: a pmax
    of m, psums of the rescaled l and o (flash-decoding).  A batch row
    needs no other row, so the batch runs whole in each shard."""
    b, h, hd = q.shape
    hkv = k_cache.shape[2]
    qg = q.reshape(b, hkv, h // hkv, hd)
    if not (par is not None and par.active and seq_axes):
        m, l, o = _plain_decode(qg, k_cache, v_cache, lengths)
        out = o / torch.clamp(l, min=1e-30)[..., None]
        return out.reshape(b, h, hd).to(q.dtype)
    mesh = par.mesh.sub(seq_axes)
    s, n = k_cache.shape[1], mesh.size
    if s % n:
        raise ValueError(f"cache length {s} does not split over {n} "
                         f"shards of {seq_axes}")
    s_loc = s // n
    parts = [_plain_decode(qg, k_cache[:, r * s_loc:(r + 1) * s_loc],
                           v_cache[:, r * s_loc:(r + 1) * s_loc], lengths,
                           seq_offset=r * s_loc) for r in range(n)]
    mg = mesh.pmax([m for m, _, _ in parts])
    corr = [torch.exp(m - g) for (m, _, _), g in zip(parts, mg)]
    lg = mesh.psum([l * c for (_, l, _), c in zip(parts, corr)])
    og = mesh.psum([o * c[..., None] for (_, _, o), c in zip(parts, corr)])
    out = og[0] / torch.clamp(lg[0], min=1e-30)[..., None]
    return out.reshape(b, h, hd).to(q.dtype)


def decode_self_attention(params, x_tok: torch.Tensor, cache: dict,
                          lengths: torch.Tensor, *, n_heads: int, n_kv: int,
                          hd: int, rope_theta: float, par=None,
                          seq_axes: Tuple[str, ...] = (), window: int = 0
                          ) -> Tuple[torch.Tensor, dict]:
    """One decode step.  x_tok: (B, D); cache: {"k","v"}: (B, S, Hkv, hd),
    written in place at each row's position ``lengths``.  With
    ``window`` the cache is a ring buffer: the slot is ``lengths % S``
    and the valid slots are ``min(lengths + 1, window)``, each within the
    window by construction; a ring never shards its sequence.  Under a
    mesh with ``par.decode_kv_head_shard`` the caches are laid out by KV
    head (each head's whole sequence: the plain path); else the sequence
    shards over ``seq_axes`` (``flash_decode``).

    Returns (out (B, D), cache)."""
    b, _ = x_tok.shape
    q = (x_tok @ params["wq"]).reshape(b, 1, n_heads, hd)
    k = (x_tok @ params["wk"]).reshape(b, 1, n_kv, hd)
    v = (x_tok @ params["wv"]).reshape(b, 1, n_kv, hd)
    q = apply_rope(q, lengths[:, None], rope_theta)[:, 0]
    k = apply_rope(k, lengths[:, None], rope_theta)[:, 0]
    s_cache = cache["k"].shape[1]
    bidx = torch.arange(b, device=x_tok.device)
    slot = (lengths % s_cache if window else lengths).long()
    cache["k"][bidx, slot] = k.to(cache["k"].dtype)
    cache["v"][bidx, slot] = v[:, 0].to(cache["v"].dtype)
    valid = torch.clamp(lengths + 1, max=window) if window else lengths + 1
    if window:
        seq_axes = ()
    elif par is not None and par.active and par.decode_kv_head_shard:
        kvspec = (par.batch(), None, par.model_axis, None)
        par.shard(cache["k"], *kvspec)
        par.shard(cache["v"], *kvspec)
        par.shard(q.reshape(b, n_kv, n_heads // n_kv, hd), par.batch(),
                  par.model_axis, None, None)
        seq_axes = ()
    out = flash_decode(q, cache["k"], cache["v"], valid, par,
                       seq_axes=seq_axes).reshape(b, n_heads * hd)
    return out.to(x_tok.dtype) @ params["wo"], cache


def decode_cross_attention(params, x_tok: torch.Tensor, memory_kv: dict, *,
                           n_heads: int, n_kv: int, hd: int) -> torch.Tensor:
    """Cross attention at decode: x_tok (B, D) against the memory's static
    K/V ``{"k", "v"}`` (B, Sk, Hkv, hd), every key valid, no RoPE."""
    b, _ = x_tok.shape
    q = (x_tok @ params["wq"]).reshape(b, n_heads, hd)
    mlen = memory_kv["k"].shape[1]
    lengths = torch.full((b,), mlen, dtype=torch.int32, device=x_tok.device)
    out = flash_decode(q, memory_kv["k"], memory_kv["v"],
                       lengths).reshape(b, n_heads * hd)
    return out.to(x_tok.dtype) @ params["wo"]
