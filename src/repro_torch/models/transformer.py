"""Model assembly: block-pattern transformer / SSM / MoE / hybrid LMs.

A model is a ``Transformer`` module: the token table, an
``nn.ModuleList`` of per-layer ``Layer`` modules in execution order
(the reference scans a stacked copy of the block pattern; here the
``repeats`` copies and the ``tail`` are unrolled), the final norm and
the LM head; with a ``SHARED_ATTN`` layer kind, the one ``shared``
attention block that every such layer runs (weight tying: its grads add
up over the uses); with ``encoder_layers``, the bidirectional
``encoder`` over stub audio frames; with ``num_image_tokens``, the
``img_proj`` of stub image embeddings.  The encoder's output or the
projected image tokens are the memory that ``CROSS`` layers attend to.
Entry points, with the reference's signatures (``params`` is the
module):

  forward_train(params, batch, cfg, par)   -> (loss, metrics)
  forward_embed(params, batch, cfg, par)   -> (B, D) f32 unit rows
  prefill(params, batch, cfg, par, cache_len) -> (h_last, caches, lengths)
  decode_step(params, caches, token, lengths, cfg, par) -> (h_last, caches)

``batch`` holds (B, S) ``tokens`` (and ``labels`` to train), plus
(B, encoder_seq, D) ``frames`` or (B, num_image_tokens, D)
``image_embeds`` where the config has them.

Each layer kind has its own decode cache (``init_caches``): a full KV
cache (``ATTN``, ``MOE``, ``SHARED_ATTN``, ``CROSS``), a ring of
``min(window, cache_len)`` slots (``SWA``: slot = position % size), the
memory's K/V (``CROSS``), the conv window and the float32 SSM state
(``MAMBA1`` / ``MAMBA2``).  Decode writes them in place (the reference's
buffer donation).  A sliding-window prefill keeps the whole prompt's last
``min(S, size)`` tokens in its ring; the reference's keeps only the last
``size - S`` of a prompt shorter than the ring (w / 2 < S < w loses
tokens), which the port does not copy.

``forward_train`` with ``par.remat == "block"`` runs each repeat of the
block pattern, each tail layer and each encoder layer under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of its
scanned bodies): the backward pass recomputes them from their inputs.
Its loss adds 0.01 x the MoE layers' summed load-balancing loss.

Under a mesh (``par.mesh``) the entry points run the per-shard sites of
``models.parallel`` (the vocab-sharded embed, loss and sample, the
sequence-sharded decode, the per-shard MoE dispatch) and check the
layouts: the activations between layers (``par.shard_activations``)
and, in ``prefill``, each cache against ``cache_specs``.
``param_specs`` and ``cache_specs`` are the reference's spec trees.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (ATTN, CROSS, MAMBA1, MAMBA2, MOE,
                                      SHARED_ATTN, SWA, ArchConfig)
from repro_torch.core.index import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import embedding as emb_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.common import (dense_init, mlp_apply, mlp_init,
                                       mlp_specs, params_dict, rmsnorm,
                                       rmsnorm_init)
from repro_torch.models.parallel import ParallelConfig

__all__ = ["Layer", "Transformer", "Encoder", "check_ported", "init_params",
           "param_specs", "forward_train", "hidden_states", "forward_embed",
           "init_caches", "cache_specs", "init_specs_placeholder",
           "layer_cache_specs", "prefill", "decode_step", "FLOAT32_LEAVES"]

KINDS = (ATTN, SWA, MOE, MAMBA1, MAMBA2, SHARED_ATTN, CROSS)
ATTN_KINDS = (ATTN, SWA, MOE, CROSS, SHARED_ATTN)
# leaves that are float32 whatever the config's dtype (the reference's)
FLOAT32_LEAVES = frozenset({"router", "A_log", "D", "dt_bias"})


class Layer(nn.Module):
    """One layer of ``kind``, holding the reference's leaves of that kind
    under the reference's names: ``norm1``, ``attn``, ``norm2`` and
    ``mlp`` or ``moe``, plus ``normx`` and ``xattn`` for ``CROSS``;
    ``norm1`` and ``mixer`` for Mamba; only ``marker`` for
    ``SHARED_ATTN``, whose weights live in ``Transformer.shared``.  A
    leaf is a tensor or a dict of tensors."""

    def __init__(self, kind: str, **leaves):
        super().__init__()
        self.kind = kind
        for name, v in leaves.items():
            if isinstance(v, nn.ParameterDict):
                setattr(self, name, v)
            elif isinstance(v, dict):
                setattr(self, name, params_dict(**v))
            else:
                setattr(self, name, nn.Parameter(v, requires_grad=False))


class Encoder(nn.Module):
    """The Whisper-style bidirectional encoder: ``ATTN`` blocks run
    without the causal mask, then a final norm."""

    def __init__(self, blocks: Sequence[Layer], final_norm):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)


class Transformer(nn.Module):
    def __init__(self, embed, blocks: Sequence[Layer], final_norm, lm_head,
                 shared: Optional[Layer] = None,
                 encoder: Optional[Encoder] = None, img_proj=None):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        self.lm_head = nn.Parameter(lm_head, requires_grad=False)
        self.shared = shared
        self.encoder = encoder
        self.img_proj = (None if img_proj is None
                         else nn.Parameter(img_proj, requires_grad=False))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def nbytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in self.parameters())


def check_ported(cfg: ArchConfig) -> None:
    """Raise ``ValueError`` for a layer kind the model zoo does not know,
    or an MoE or Mamba layer without its ``moe`` / ``ssm`` spec."""
    for kind in cfg.pattern + cfg.tail:
        if kind not in KINDS:
            raise ValueError(f"{cfg.name}: unknown layer kind {kind!r}")
        if kind == MOE and cfg.moe is None:
            raise ValueError(f"{cfg.name}: a '{MOE}' layer needs cfg.moe")
        if kind in (MAMBA1, MAMBA2) and cfg.ssm is None:
            raise ValueError(f"{cfg.name}: a '{kind}' layer needs cfg.ssm")


def layer_kinds(cfg: ArchConfig) -> List[str]:
    """The kind of each layer in execution order: repeat by repeat,
    pattern position by pattern position, then the tail."""
    return list(cfg.pattern) * cfg.n_repeats + list(cfg.tail)


def _dt_rank(cfg: ArchConfig) -> int:
    return cfg.ssm.dt_rank or -(-cfg.d_model // 16)


# ===================================================================== init

def _attn_block(gen, cfg: ArchConfig, dt, device) -> Dict:
    d = cfg.d_model
    return dict(norm1=rmsnorm_init(d, dt, device),
                attn=attn_lib.init_attn(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                        cfg.hd, dt, device),
                norm2=rmsnorm_init(d, dt, device))


def _init_layer(gen, kind: str, cfg: ArchConfig, dt, device) -> Layer:
    d = cfg.d_model
    if kind == SHARED_ATTN:
        return Layer(kind, marker=torch.zeros((1,), dtype=dt, device=device))
    if kind in (MAMBA1, MAMBA2):
        s = cfg.ssm
        mixer = (ssm_lib.init_mamba1(gen, d, s.d_state, s.expand, s.d_conv,
                                     s.dt_rank, dt, device) if kind == MAMBA1
                 else ssm_lib.init_mamba2(gen, d, s.d_state, s.expand,
                                          s.d_conv, s.head_dim, dt, device))
        return Layer(kind, norm1=rmsnorm_init(d, dt, device), mixer=mixer)
    leaves = _attn_block(gen, cfg, dt, device)
    if kind == MOE:
        leaves["moe"] = moe_lib.init_moe(gen, d, cfg.d_ff,
                                         cfg.moe.num_experts, dt, device)
    else:
        leaves["mlp"] = mlp_init(gen, d, cfg.d_ff, dt, device)
    if kind == CROSS:
        leaves["normx"] = rmsnorm_init(d, dt, device)
        leaves["xattn"] = attn_lib.init_attn(gen, d, cfg.n_heads,
                                             cfg.n_kv_heads, cfg.hd, dt,
                                             device)
    return Layer(kind, **leaves)


def init_params(cfg: ArchConfig, seed: int = 0, device=None) -> Transformer:
    """Random weights drawn on ``device`` (None: the GPU) from a
    generator seeded with ``seed``, one leaf at a time: each is drawn in
    float32 and cast to ``cfg.param_dtype`` (``FLOAT32_LEAVES`` stay
    float32) before the next.  On the "meta" device the weights have
    shapes and dtypes only (no draws): a model's bytes are counted there
    before it is built."""
    check_ported(cfg)
    device = resolve_device(device)
    gen = (None if device.type == "meta"
           else torch.Generator(device=device).manual_seed(int(seed)))
    dt, d = cfg.param_dtype, cfg.d_model
    embed = emb_lib.init_table(gen, cfg.vocab, d, dt, device)
    blocks = [_init_layer(gen, kind, cfg, dt, device)
              for kind in layer_kinds(cfg)]
    head = emb_lib.init_table(gen, cfg.vocab, d, dt, device)
    shared = encoder = img_proj = None
    if SHARED_ATTN in cfg.pattern + cfg.tail:
        shared = Layer(ATTN, **_attn_block(gen, cfg, dt, device),
                       mlp=mlp_init(gen, d, cfg.d_ff, dt, device))
    if cfg.encoder_layers:
        encoder = Encoder([_init_layer(gen, ATTN, cfg, dt, device)
                           for _ in range(cfg.encoder_layers)],
                          rmsnorm_init(d, dt, device))
    if cfg.num_image_tokens:
        img_proj = dense_init(gen, (d, d), 0, dtype=dt, device=device)
    return Transformer(embed, blocks, rmsnorm_init(d, dt, device), head,
                       shared, encoder, img_proj)


def from_leaves(cfg: ArchConfig, tree) -> Transformer:
    """A ``Transformer`` of given tensors: ``tree`` holds ``embed``,
    ``final_norm``, ``lm_head``, ``layers`` (one dict of leaves a layer,
    in execution order, as ``Layer`` takes them) and, where the config
    has them, ``shared`` (a dict of an ``ATTN`` layer's leaves),
    ``encoder`` ({"blocks": a list of such dicts, "final_norm"}) and
    ``img_proj``."""
    check_ported(cfg)
    blocks = [Layer(kind, **lp)
              for kind, lp in zip(layer_kinds(cfg), tree["layers"])]
    shared = (Layer(ATTN, **tree["shared"]) if tree.get("shared") is not None
              else None)
    enc = tree.get("encoder")
    encoder = (None if enc is None else
               Encoder([Layer(ATTN, **lp) for lp in enc["blocks"]],
                       enc["final_norm"]))
    return Transformer(tree["embed"], blocks, tree["final_norm"],
                       tree["lm_head"], shared, encoder, tree.get("img_proj"))


# ================================================================ specs

def _layer_specs(kind: str, cfg: ArchConfig, par: ParallelConfig,
                 stacked: bool = True):
    st = (None,) if stacked else ()
    if kind == SHARED_ATTN:
        return {"marker": st}
    out = {"norm1": st}
    if kind in (ATTN, SWA, MOE, CROSS):
        out["attn"] = attn_lib.attn_specs(par, stacked)
        out["norm2"] = st
        if kind == MOE:
            out["moe"] = moe_lib.moe_specs(par, stacked)
        else:
            out["mlp"] = mlp_specs(par, stacked)
        if kind == CROSS:
            out["normx"] = st
            out["xattn"] = attn_lib.attn_specs(par, stacked)
    elif kind == MAMBA1:
        out["mixer"] = ssm_lib.mamba1_specs(par, stacked)
    elif kind == MAMBA2:
        out["mixer"] = ssm_lib.mamba2_specs(par, stacked)
    return out


def param_specs(cfg: ArchConfig, par: ParallelConfig) -> Dict[str, Any]:
    """The spec tree of the reference's params layout (one stacked
    ``(repeats, ...)`` leaf a pattern position: a leading None); a
    parameter of the port takes its leaf's spec through
    ``train.step.named_specs``."""
    specs: Dict[str, Any] = {
        "embed": par.w_vocab(),
        "blocks": tuple(_layer_specs(k, cfg, par, True)
                        for k in cfg.pattern),
        "tail": tuple(_layer_specs(k, cfg, par, False) for k in cfg.tail),
        "final_norm": (),
        "lm_head": par.w_vocab(),
    }
    if SHARED_ATTN in cfg.pattern + cfg.tail:
        specs["shared"] = {
            "norm1": (), "attn": attn_lib.attn_specs(par, False),
            "norm2": (), "mlp": mlp_specs(par, False),
        }
    if cfg.encoder_layers:
        specs["encoder"] = {"blocks": _layer_specs(ATTN, cfg, par, True),
                            "final_norm": ()}
    if cfg.num_image_tokens:
        specs["img_proj"] = (par.fsdp_axis(),
                             par.model_axis if par.active else None)
    return specs


# ============================================================== forward

def _attn_kwargs(cfg: ArchConfig, par: ParallelConfig):
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=cfg.hd,
                rope_theta=cfg.rope_theta, chunk_q=par.attn_chunk_q,
                chunk_k=par.attn_chunk_k, remat_qchunk=par.attn_remat,
                probs_bf16=par.attn_probs_bf16)


def _tokens(batch, device, key: str = "tokens") -> torch.Tensor:
    """A batch's (B, S) ``key`` ids as int64 on ``device`` (numpy, or a
    tensor anywhere)."""
    t = batch[key]
    if not isinstance(t, torch.Tensor):
        t = torch.from_numpy(np.array(t))     # a writable copy
    return t.to(device=device, dtype=torch.int64)


def _embeds(batch, key: str, device, dtype) -> torch.Tensor:
    """A batch's stub ``frames`` or ``image_embeds`` (numpy, or a tensor
    anywhere) in ``dtype`` on ``device``."""
    t = batch[key]
    if not isinstance(t, torch.Tensor):
        t = torch.from_numpy(np.array(t, dtype=np.float32))
    return t.to(device=device, dtype=dtype)


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def _zero(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=device)


def _fill_kv(cache, k: torch.Tensor, v: torch.Tensor) -> None:
    """Write a prompt's (B, S, Hkv, hd) k and v (positions 0..S-1) into a
    KV cache: positions 0..S-1 of a full cache; the last min(S, size)
    positions of a ring at slot position % size."""
    s, size = k.shape[1], cache["k"].shape[1]
    n = min(s, size)
    slots = torch.arange(s - n, s, device=k.device) % size
    cache["k"][:, slots] = k[:, s - n:]
    cache["v"][:, slots] = v[:, s - n:]


def _layer(lp: Layer, h: torch.Tensor, positions: torch.Tensor,
           cfg: ArchConfig, par: ParallelConfig, memory=None, shared=None,
           cache=None, causal: bool = True):
    """One layer on the (B, S, D) residual stream -> (h, aux), aux the MoE
    load-balancing loss (float32 0-d; 0 for other kinds).  With
    ``cache``, the layer's decode cache is written: k and v, the memory's
    K/V, or the SSM's conv window and final state."""
    eps, kind = cfg.norm_eps, lp.kind
    aux = _zero(h.device)
    if kind in (MAMBA1, MAMBA2):
        s = cfg.ssm
        x = rmsnorm(h, lp.norm1, eps)
        want = cache is not None
        if kind == MAMBA1:
            out = ssm_lib.mamba1_block(
                lp.mixer, x, d_state=s.d_state, chunk=s.chunk,
                dt_rank=_dt_rank(cfg), return_state=want,
                remat=par.ssm_remat)
        else:
            out = ssm_lib.mamba2_block(
                lp.mixer, x, d_state=s.d_state, head_dim=s.head_dim,
                chunk=s.chunk, norm_eps=eps, return_state=want,
                remat=par.ssm_remat)
        if want:
            out, state = out
            cache["conv"].copy_(state["conv"])
            cache["ssm"].copy_(state["ssm"])
        return h + out, aux
    p = shared if kind == SHARED_ATTN else lp
    window = cfg.sliding_window if kind == SWA else 0
    a, k, v = attn_lib.self_attention(
        p.attn, rmsnorm(h, p.norm1, eps), positions, causal=causal,
        window=window, return_kv=True, **_attn_kwargs(cfg, par))
    if cache is not None:
        _fill_kv(cache, k, v)
    h = h + a
    if kind == CROSS:
        x, mk, mv = attn_lib.self_attention(
            lp.xattn, rmsnorm(h, lp.normx, eps), positions, causal=False,
            memory=memory, return_kv=True, **_attn_kwargs(cfg, par))
        if cache is not None:
            cache["mem_k"].copy_(mk)
            cache["mem_v"].copy_(mv)
        h = h + x
    h2 = rmsnorm(h, p.norm2, eps)
    if kind == MOE:
        mo, aux = moe_lib.moe_apply(
            lp.moe, h2, top_k=cfg.moe.top_k,
            capacity_factor=cfg.moe.capacity_factor, act=cfg.mlp_act,
            par=par)
        return h + mo, aux
    return h + mlp_apply(p.mlp, h2, cfg.mlp_act), aux


def _layers(lps: Sequence[Layer], h, positions, cfg, par, memory, shared):
    """Layers in order -> (h, the sum of their aux losses)."""
    aux = _zero(h.device)
    for lp in lps:
        h, a = _layer(lp, h, positions, cfg, par, memory, shared)
        aux = aux + a
    return par.shard_activations(h), aux


def _memory(params: Transformer, batch, cfg: ArchConfig, par: ParallelConfig,
            remat: bool = False) -> Optional[torch.Tensor]:
    """What ``CROSS`` layers attend to: the encoder over the stub
    ``frames`` (bidirectional; each layer checkpointed with ``remat``),
    ``image_embeds @ img_proj``, or None."""
    dev, dt = params.device, cfg.param_dtype
    if cfg.encoder_layers:
        h = _embeds(batch, "frames", dev, dt)
        pos = torch.arange(h.shape[1], dtype=torch.int32, device=dev)
        for lp in params.encoder.blocks:
            if remat:
                h, _ = checkpoint(_layer, lp, h, pos, cfg, par, causal=False,
                                  use_reentrant=False)
            else:
                h, _ = _layer(lp, h, pos, cfg, par, causal=False)
            par.shard_activations(h)
        return rmsnorm(h, params.encoder.final_norm, cfg.norm_eps)
    if cfg.num_image_tokens:
        return par.shard_activations(
            _embeds(batch, "image_embeds", dev, dt) @ params.img_proj)
    return None


def _forward(params: Transformer, batch, cfg: ArchConfig,
             par: ParallelConfig, caches=None) -> torch.Tensor:
    """(B, S, D) final-normed hidden states of a batch; with ``caches``
    (``init_caches`` of the batch's size), each layer's cache written."""
    tokens = _tokens(batch, params.device)
    b, s = tokens.shape
    h = par.shard_activations(emb_lib.embed(params.embed, tokens, par))
    positions = _positions(b, s, params.device)
    memory = _memory(params, batch, cfg, par)
    for i, lp in enumerate(params.blocks):
        h, _ = _layer(lp, h, positions, cfg, par, memory, params.shared,
                      None if caches is None else caches["blocks"][i])
        par.shard_activations(h)
    return rmsnorm(h, params.final_norm, cfg.norm_eps)


def forward_train(params: Transformer, batch, cfg: ArchConfig,
                  par: ParallelConfig):
    """batch: tokens (B, S), labels (B, S) with -1 = ignore, and the
    config's frames or image embeddings (numpy, or tensors anywhere) ->
    (loss, {"ce_loss", "aux_loss"}), float32 0-d.

    The loss is ``softmax_xent`` over ``par.logits_chunk`` chunks of the
    sequence, plus 0.01 x ``aux_loss``, the MoE layers' summed
    load-balancing loss (0 without MoE layers)."""
    tokens = _tokens(batch, params.device)
    labels = _tokens(batch, params.device, "labels")
    b, s = tokens.shape
    remat = par.remat == "block"
    h = par.shard_activations(emb_lib.embed(params.embed, tokens, par))
    positions = _positions(b, s, params.device)
    memory = _memory(params, batch, cfg, par, remat)
    n = len(cfg.pattern)
    groups = [params.blocks[i:i + n]
              for i in range(0, n * cfg.n_repeats, n)]
    groups += [[lp] for lp in params.blocks[n * cfg.n_repeats:]]
    aux = _zero(params.device)
    for g in groups:
        if remat:
            h, a = checkpoint(_layers, g, h, positions, cfg, par, memory,
                              params.shared, use_reentrant=False)
        else:
            h, a = _layers(g, h, positions, cfg, par, memory, params.shared)
        aux = aux + a
    h = rmsnorm(h, params.final_norm, cfg.norm_eps)
    loss = emb_lib.softmax_xent(params.lm_head, h, labels, par,
                                chunk=par.logits_chunk)
    return loss + 0.01 * aux, {"ce_loss": loss, "aux_loss": aux}


def hidden_states(params: Transformer, batch, cfg: ArchConfig,
                  par: ParallelConfig) -> torch.Tensor:
    """(B, S, D) final-normed hidden states of a batch."""
    return _forward(params, batch, cfg, par)


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

def _cache_for(kind: str, cfg: ArchConfig, b: int, cache_len: int,
               memory_len: int, device) -> Dict[str, torch.Tensor]:
    dt = cfg.param_dtype
    hkv, hd = cfg.n_kv_heads, cfg.hd

    def z(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    if kind in ATTN_KINDS:
        size = min(cfg.sliding_window, cache_len) if kind == SWA \
            else cache_len
        c = {"k": z(b, size, hkv, hd), "v": z(b, size, hkv, hd)}
        if kind == CROSS:
            c["mem_k"] = z(b, memory_len, hkv, hd)
            c["mem_v"] = z(b, memory_len, hkv, hd)
        return c
    s = cfg.ssm
    di = s.expand * cfg.d_model
    conv_ch = di if kind == MAMBA1 else di + 2 * s.d_state
    state = ((b, di, s.d_state) if kind == MAMBA1
             else (b, di // s.head_dim, s.head_dim, s.d_state))
    return {"conv": z(b, s.d_conv - 1, conv_ch),
            "ssm": z(*state, dtype=torch.float32)}


def init_caches(cfg: ArchConfig, b: int, cache_len: int, device=None,
                memory_len: int = 0
                ) -> Dict[str, List[Dict[str, torch.Tensor]]]:
    """Zeroed decode caches on ``device`` (None: the GPU), one dict a
    layer in execution order: ``{"k", "v"}`` of (B, cache_len, Hkv, hd)
    (a ring of min(sliding_window, cache_len) slots for ``SWA``), plus
    ``{"mem_k", "mem_v"}`` of (B, memory_len, Hkv, hd) for ``CROSS``, in
    ``cfg.param_dtype``; ``{"conv": (B, d_conv - 1, channels), "ssm":
    float32 state}`` for Mamba."""
    check_ported(cfg)
    device = resolve_device(device)
    return {"blocks": [_cache_for(kind, cfg, b, cache_len, memory_len,
                                  device) for kind in layer_kinds(cfg)]}


def cache_specs(cfg: ArchConfig, par: ParallelConfig):
    """The spec tree of the reference's caches layout (one stacked cache
    a pattern position, then the tail); ``layer_cache_specs`` maps it
    onto the port's layers."""
    if not par.active:
        return init_specs_placeholder()
    batch = par.batch()
    seqax = par.decode_seq_shard or None

    def spec_for(kind, stacked):
        st = (None,) if stacked else ()
        if kind in (ATTN, MOE, SHARED_ATTN, CROSS):
            if par.decode_kv_head_shard:
                kv = st + (batch, None, par.model_axis, None)
            else:
                kv = st + (batch, seqax, None, None)
            c = {"k": kv, "v": kv}
            if kind == CROSS:
                c["mem_k"] = st + (batch, None, None, None)
                c["mem_v"] = st + (batch, None, None, None)
            return c
        if kind == SWA:
            kv = st + (batch, None, None, None)
            return {"k": kv, "v": kv}
        ma = par.model_axis
        if kind == MAMBA1:
            return {"conv": st + (batch, None, ma),
                    "ssm": st + (batch, ma, None)}
        return {"conv": st + (batch, None, ma),
                "ssm": st + (batch, ma, None, None)}

    return {
        "blocks": tuple(spec_for(k, True) for k in cfg.pattern),
        "tail": tuple(spec_for(k, False) for k in cfg.tail),
    }


def init_specs_placeholder():
    return {"blocks": (), "tail": ()}


def layer_cache_specs(cfg: ArchConfig, par: ParallelConfig
                      ) -> List[Dict[str, tuple]]:
    """``cache_specs`` a layer in execution order, as ``init_caches``
    lays the caches out (a stacked spec without its leading None)."""
    tree, n = cache_specs(cfg, par), len(cfg.pattern)
    return ([{k: v[1:] for k, v in tree["blocks"][i % n].items()}
             for i in range(n * cfg.n_repeats)] + list(tree["tail"]))


# ============================================================== prefill

def _memory_len(batch, cfg: ArchConfig) -> int:
    """The length of the batch's memory: its frames or image tokens."""
    if cfg.encoder_layers:
        return batch["frames"].shape[1]
    return batch["image_embeds"].shape[1] if cfg.num_image_tokens else 0


def prefill(params: Transformer, batch, cfg: ArchConfig, par: ParallelConfig,
            cache_len: int):
    """Process the prompt, build decode caches.

    Returns (h_last (B, D), caches, lengths (B,) int32)."""
    tokens = _tokens(batch, params.device)
    b, s = tokens.shape
    caches = init_caches(cfg, b, cache_len, device=params.device,
                         memory_len=_memory_len(batch, cfg))
    if par.active:
        for c, spec in zip(caches["blocks"], layer_cache_specs(cfg, par)):
            for k, t in c.items():
                par.check(t, spec[k], even=True)
    h = _forward(params, batch, cfg, par, caches)
    lengths = torch.full((b,), s, dtype=torch.int32, device=params.device)
    return h[:, -1], caches, lengths


# =============================================================== decode

def _decode_layer(lp: Layer, h: torch.Tensor, cache, lengths, cfg, par,
                  shared):
    eps, kind = cfg.norm_eps, lp.kind
    if kind in (MAMBA1, MAMBA2):
        s = cfg.ssm
        x = rmsnorm(h, lp.norm1, eps)
        if kind == MAMBA1:
            y, st = ssm_lib.mamba1_decode(lp.mixer, x, cache,
                                          d_state=s.d_state,
                                          dt_rank=_dt_rank(cfg))
        else:
            y, st = ssm_lib.mamba2_decode(lp.mixer, x, cache,
                                          d_state=s.d_state,
                                          head_dim=s.head_dim, norm_eps=eps)
        cache["conv"].copy_(st["conv"])
        cache["ssm"].copy_(st["ssm"])
        return h + y
    p = shared if kind == SHARED_ATTN else lp
    out, _ = attn_lib.decode_self_attention(
        p.attn, rmsnorm(h, p.norm1, eps), cache, lengths,
        n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=cfg.hd,
        rope_theta=cfg.rope_theta, par=par,
        seq_axes=() if kind == SWA else par.decode_seq_shard,
        window=cfg.sliding_window if kind == SWA else 0)
    h = h + out
    if kind == CROSS:
        h = h + attn_lib.decode_cross_attention(
            lp.xattn, rmsnorm(h, lp.normx, eps),
            {"k": cache["mem_k"], "v": cache["mem_v"]},
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=cfg.hd)
    h2 = rmsnorm(h, p.norm2, eps)
    if kind == MOE:
        mo, _ = moe_lib.moe_apply(
            lp.moe, h2[:, None], top_k=cfg.moe.top_k,
            capacity_factor=cfg.moe.capacity_factor, act=cfg.mlp_act,
            par=par)
        return h + mo[:, 0]
    return h + mlp_apply(p.mlp, h2, cfg.mlp_act)


def decode_step(params: Transformer, caches, token: torch.Tensor,
                lengths: torch.Tensor, cfg: ArchConfig, par: ParallelConfig):
    """One token for the whole batch.  token: (B,) -> (h_last, caches);
    the caches are updated in place.  ``CROSS`` layers read the memory's
    K/V that prefill left in their caches."""
    h = emb_lib.embed(params.embed, token.long(), par)
    for lp, cache in zip(params.blocks, caches["blocks"]):
        h = _decode_layer(lp, h, cache, lengths, cfg, par, params.shared)
    return rmsnorm(h, params.final_norm, cfg.norm_eps), caches
