"""Model assembly: the dense decoder-only transformer (one device).

A model is a ``Transformer`` module: the token table, an
``nn.ModuleList`` of per-layer ``Layer`` modules in execution order
(the reference scans a stacked copy of the block pattern; here the
``repeats`` copies and the ``tail`` are unrolled), the final norm and
the LM head.  Entry points, with the reference's signatures (``params``
is the module):

  forward_train(params, batch, cfg, par)   -> (loss, metrics)
  forward_embed(params, batch, cfg, par)   -> (B, D) f32 unit rows
  prefill(params, batch, cfg, par, cache_len) -> (h_last, caches, lengths)
  decode_step(params, caches, token, lengths, cfg, par) -> (h_last, caches)

Decode writes each layer's KV cache in place (the reference's buffer
donation).  ``forward_train`` with ``par.remat == "block"`` runs each
layer under ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint`` of the scanned block): the backward pass recomputes
it from its input.  Only the ``ATTN`` layer kind is ported: any other
kind (sliding window, MoE, Mamba, cross attention, the shared block)
raises ``NotImplementedError``; those come with Slice F2.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ATTN, ArchConfig
from repro_torch.core.index import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import embedding as emb_lib
from repro_torch.models.common import (mlp_apply, mlp_init, params_dict,
                                       rmsnorm, rmsnorm_init)
from repro_torch.models.parallel import ParallelConfig

__all__ = ["Layer", "Transformer", "check_ported", "init_params",
           "forward_train", "hidden_states", "forward_embed", "init_caches",
           "prefill", "decode_step"]


class Layer(nn.Module):
    """One ``ATTN`` block: pre-norm self-attention, then a pre-norm
    gated MLP, each added to the residual stream."""

    def __init__(self, norm1, attn: nn.ParameterDict, norm2,
                 mlp: nn.ParameterDict):
        super().__init__()
        self.norm1 = nn.Parameter(norm1, requires_grad=False)
        self.attn = attn
        self.norm2 = nn.Parameter(norm2, requires_grad=False)
        self.mlp = mlp


class Transformer(nn.Module):
    def __init__(self, embed, blocks: Sequence[Layer], final_norm, lm_head):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        self.lm_head = nn.Parameter(lm_head, requires_grad=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def nbytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in self.parameters())


def check_ported(cfg: ArchConfig) -> None:
    """Raise unless every layer of ``cfg`` is a kind the port runs."""
    kinds = set(cfg.pattern) | set(cfg.tail)
    if kinds != {ATTN} or cfg.encoder_layers or cfg.num_image_tokens:
        raise NotImplementedError(
            f"{cfg.name}: layer kinds {sorted(kinds)} — only dense "
            f"'{ATTN}' stacks are ported (the rest comes with Slice F2)")


# ===================================================================== init

def _init_layer(gen, cfg: ArchConfig, dt, device) -> Layer:
    d = cfg.d_model
    return Layer(
        rmsnorm_init(d, dt, device),
        attn_lib.init_attn(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.hd, dt,
                           device),
        rmsnorm_init(d, dt, device),
        mlp_init(gen, d, cfg.d_ff, dt, device))


def init_params(cfg: ArchConfig, seed: int = 0, device=None) -> Transformer:
    """Random weights drawn on ``device`` (None: the GPU) from a
    generator seeded with ``seed``, one leaf at a time: each is drawn in
    float32 and cast to ``cfg.param_dtype`` before the next.  On the
    "meta" device the weights have shapes and dtypes only (no draws):
    a model's bytes are counted there before it is built."""
    check_ported(cfg)
    device = resolve_device(device)
    gen = (None if device.type == "meta"
           else torch.Generator(device=device).manual_seed(int(seed)))
    dt = cfg.param_dtype
    embed = emb_lib.init_table(gen, cfg.vocab, cfg.d_model, dt, device)
    blocks = [_init_layer(gen, cfg, dt, device) for _ in range(cfg.n_layers)]
    head = emb_lib.init_table(gen, cfg.vocab, cfg.d_model, dt, device)
    return Transformer(embed, blocks, rmsnorm_init(cfg.d_model, dt, device),
                       head)


def from_leaves(cfg: ArchConfig, embed, layers: List[Dict], final_norm,
                lm_head) -> Transformer:
    """A ``Transformer`` of given tensors; ``layers`` in execution order,
    each ``{"norm1", "attn": {"wq", "wk", "wv", "wo"}, "norm2",
    "mlp": {"wi", "wg", "wo"}}``."""
    check_ported(cfg)
    blocks = [Layer(lp["norm1"], params_dict(**lp["attn"]), lp["norm2"],
                    params_dict(**lp["mlp"])) for lp in layers]
    return Transformer(embed, blocks, final_norm, lm_head)


# ============================================================== forward

def _attn_kwargs(cfg: ArchConfig, par: ParallelConfig):
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=cfg.hd,
                rope_theta=cfg.rope_theta, chunk_q=par.attn_chunk_q,
                chunk_k=par.attn_chunk_k)


def _tokens(batch, device, key: str = "tokens") -> torch.Tensor:
    """A batch's (B, S) ``key`` ids as int64 on ``device`` (numpy, or a
    tensor anywhere)."""
    t = batch[key]
    if not isinstance(t, torch.Tensor):
        t = torch.from_numpy(np.array(t))     # a writable copy
    return t.to(device=device, dtype=torch.int64)


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def _layer(lp: Layer, h: torch.Tensor, positions: torch.Tensor,
           cfg: ArchConfig, par: ParallelConfig, cache=None) -> torch.Tensor:
    """One layer on the (B, S, D) residual stream; with ``cache``, its
    (post-RoPE) k and v written into the cache's first S positions."""
    a, k, v = attn_lib.self_attention(
        lp.attn, rmsnorm(h, lp.norm1, cfg.norm_eps), positions,
        causal=True, return_kv=True, **_attn_kwargs(cfg, par))
    if cache is not None:
        cache["k"][:, :h.shape[1]] = k
        cache["v"][:, :h.shape[1]] = v
    h = h + a
    return h + mlp_apply(lp.mlp, rmsnorm(h, lp.norm2, cfg.norm_eps),
                         cfg.mlp_act)


def _forward(params: Transformer, tokens: torch.Tensor, cfg: ArchConfig,
             par: ParallelConfig, caches=None) -> torch.Tensor:
    """(B, S, D) final-normed hidden states of (B, S) tokens; with
    ``caches``, each layer's k and v written into its cache."""
    b, s = tokens.shape
    h = emb_lib.embed(params.embed, tokens)
    positions = _positions(b, s, params.device)
    for i, lp in enumerate(params.blocks):
        h = _layer(lp, h, positions, cfg, par,
                   None if caches is None else caches["blocks"][i])
    return rmsnorm(h, params.final_norm, cfg.norm_eps)


def forward_train(params: Transformer, batch, cfg: ArchConfig,
                  par: ParallelConfig):
    """batch: tokens (B, S), labels (B, S) with -1 = ignore (numpy, or
    tensors anywhere) -> (loss, {"ce_loss", "aux_loss"}), float32 0-d.

    The loss is ``softmax_xent`` over ``par.logits_chunk`` chunks of the
    sequence; ``aux_loss`` is 0 on the dense path (the reference adds
    0.01 x the MoE load-balance loss)."""
    check_ported(cfg)
    tokens = _tokens(batch, params.device)
    labels = _tokens(batch, params.device, "labels")
    b, s = tokens.shape
    h = emb_lib.embed(params.embed, tokens)
    positions = _positions(b, s, params.device)
    for lp in params.blocks:
        if par.remat == "block":
            h = checkpoint(_layer, lp, h, positions, cfg, par,
                           use_reentrant=False)
        else:
            h = _layer(lp, h, positions, cfg, par)
    h = rmsnorm(h, params.final_norm, cfg.norm_eps)
    loss = emb_lib.softmax_xent(params.lm_head, h, labels,
                                chunk=par.logits_chunk)
    aux = torch.zeros((), dtype=torch.float32, device=params.device)
    return loss + 0.01 * aux, {"ce_loss": loss, "aux_loss": aux}


def hidden_states(params: Transformer, batch, cfg: ArchConfig,
                  par: ParallelConfig) -> torch.Tensor:
    """(B, S, D) final-normed hidden states of a token batch."""
    return _forward(params, _tokens(batch, params.device), cfg, par)


def forward_embed(params: Transformer, batch, cfg: ArchConfig,
                  par: ParallelConfig) -> torch.Tensor:
    """Mean-pooled final-hidden embedding (the retrieval encoder path).

    Returns (B, D) float32, L2-normalized — the vectors the Hybrid LSH
    index stores and queries in ``serve.retrieval``.
    """
    emb = hidden_states(params, batch, cfg, par).float().mean(dim=1)
    return emb / torch.clamp(torch.linalg.norm(emb, dim=-1, keepdim=True),
                             min=1e-9)


# =============================================================== caches

def init_caches(cfg: ArchConfig, b: int, cache_len: int, device=None
                ) -> Dict[str, List[Dict[str, torch.Tensor]]]:
    """Zeroed KV caches, one ``{"k", "v"}`` of (B, cache_len, Hkv, hd)
    a layer, in ``cfg.param_dtype`` on ``device`` (None: the GPU)."""
    check_ported(cfg)
    device = resolve_device(device)
    shape = (b, cache_len, cfg.n_kv_heads, cfg.hd)

    def z():
        return torch.zeros(shape, dtype=cfg.param_dtype, device=device)
    return {"blocks": [{"k": z(), "v": z()} for _ in range(cfg.n_layers)]}


# ============================================================== prefill

def prefill(params: Transformer, batch, cfg: ArchConfig, par: ParallelConfig,
            cache_len: int):
    """Process the prompt, build decode caches.

    Returns (h_last (B, D), caches, lengths (B,) int32)."""
    tokens = _tokens(batch, params.device)
    b, s = tokens.shape
    caches = init_caches(cfg, b, cache_len, device=params.device)
    h = _forward(params, tokens, cfg, par, caches)
    lengths = torch.full((b,), s, dtype=torch.int32, device=params.device)
    return h[:, -1], caches, lengths


# =============================================================== decode

def decode_step(params: Transformer, caches, token: torch.Tensor,
                lengths: torch.Tensor, cfg: ArchConfig, par: ParallelConfig):
    """One token for the whole batch.  token: (B,) -> (h_last, caches);
    the caches are updated in place."""
    h = emb_lib.embed(params.embed, token.long())
    for lp, cache in zip(params.blocks, caches["blocks"]):
        out, _ = attn_lib.decode_self_attention(
            lp.attn, rmsnorm(h, lp.norm1, cfg.norm_eps), cache, lengths,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=cfg.hd,
            rope_theta=cfg.rope_theta)
        h = h + out
        h = h + mlp_apply(lp.mlp, rmsnorm(h, lp.norm2, cfg.norm_eps),
                          cfg.mlp_act)
    return rmsnorm(h, params.final_norm, cfg.norm_eps), caches
