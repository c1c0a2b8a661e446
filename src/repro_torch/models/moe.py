"""Mixture-of-Experts MLP with sort-based (gather/scatter) dispatch.

The arithmetic of ``repro.models.moe.moe_apply``: a float32 router,
softmax and top-k; the Switch-style load-balancing loss
E * sum_e f_e p_e; the (token, choice) pairs sorted by expert with a
stable sort, each pair's position in its expert's group, and the
capacity clamp ``int(capacity_factor * T * top_k / E) or 1`` (pairs past
it are dropped: their gate mass stays out of the combine); the kept
tokens scattered into an (E, C, D) buffer, the stacked-expert products,
and a float32 combine that adds each kept pair's gate-weighted output at
its token.  No (tokens, experts, capacity) one-hot tensor.

The combine is an ``index_add_``: on the GPU its float32 additions run
in no fixed order (atomics), so outputs agree with another order within
float32 rounding, not bit for bit.  Where the capacity is large (a
capacity factor of E / top_k holds every token), the experts run in
passes of at most MAX_BUFFER buffer entries, each pass over its experts'
run of the sorted pairs, adding their outputs; on the meta device (a dry
run, where the runs' bounds cannot be read) one pass takes every expert,
the same products.  Under a mesh,
``moe_local_dispatch`` gives each batch shard its own sort and capacity
(``_moe_apply_local``, the reference's ``shard_map``).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init, params_dict


# entries of the (experts, capacity, width) buffers a pass of moe_apply
MAX_BUFFER = 1 << 28


def init_moe(gen: torch.Generator, d_model: int, d_ff: int,
             num_experts: int, dtype=torch.bfloat16, device=None):
    """The router (float32 whatever ``dtype``) and the stacked experts'
    gated-MLP weights."""
    return params_dict(
        router=dense_init(gen, (d_model, num_experts), 0,
                          dtype=torch.float32, device=device),
        wi=dense_init(gen, (num_experts, d_model, d_ff), 1, dtype=dtype,
                      device=device),
        wg=dense_init(gen, (num_experts, d_model, d_ff), 1, dtype=dtype,
                      device=device),
        wo=dense_init(gen, (num_experts, d_ff, d_model), 1, dtype=dtype,
                      device=device))


def moe_specs(par, stacked: bool = True):
    st = (None,) if stacked else ()
    ma = par.model_axis if par.active else None
    fa = par.fsdp_axis()
    return {"router": st + (None, None),
            "wi": st + (ma, fa, None),
            "wg": st + (ma, fa, None),
            "wo": st + (ma, fa, None)}


def capacity(t: int, top_k: int, num_experts: int,
             capacity_factor: float) -> int:
    """Slots an expert keeps for ``t`` tokens (the reference's clamp)."""
    return int(capacity_factor * t * top_k / num_experts) or 1


def expert_counts(expert: torch.Tensor, e: int) -> torch.Tensor:
    """(E,) int64 count of each expert id in ``expert``: a
    ``scatter_add_`` (exact for integers on any device, and one that runs
    on the meta device, where ``bincount`` has no kernel)."""
    return torch.zeros(e, dtype=torch.int64, device=expert.device
                       ).scatter_add_(0, expert.reshape(-1),
                                      torch.ones_like(expert.reshape(-1)))


def dispatch(probs: torch.Tensor, top_k: int, cap: int):
    """The routing of (T, E) router probabilities: top-k, then the
    (token, choice) pairs sorted stably by expert.  Returns (gate, token,
    expert, slot) of the sorted pairs, float32 / int64 / int64 / int64,
    where ``slot`` is ``expert * cap + position`` for a kept pair and
    ``E * cap`` (past the buffer) for a dropped one, and the top-k
    experts (T, top_k)."""
    t, e = probs.shape
    gate, expert = torch.topk(probs, top_k, dim=-1)           # (T, K)
    flat_expert = expert.reshape(-1)
    order = torch.sort(flat_expert, stable=True).indices
    se = flat_expert[order]
    sg = gate.reshape(-1)[order]
    stok = torch.div(order, top_k, rounding_mode="floor")
    counts = expert_counts(se, e)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t * top_k, device=probs.device) - starts[se]
    slot = torch.where(pos < cap, se * cap + pos, e * cap)
    return sg, stok, se, slot, expert


def moe_apply(params, x: torch.Tensor, *, top_k: int,
              capacity_factor: float, act: str = "silu", par=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D) in x's dtype, aux_loss float32
    0-d).  Under a mesh with ``par.moe_local_dispatch``, where the batch
    has a token for each batch shard, each shard dispatches its own
    tokens (``_moe_apply_local``)."""
    b, s, d = x.shape
    t = b * s
    if par is not None and par.active and par.moe_local_dispatch \
            and t >= par.axis_size(par.batch_axes_):
        return _moe_apply_local(params, x, top_k=top_k,
                                capacity_factor=capacity_factor, act=act,
                                par=par)
    e = params["router"].shape[1]
    xt = x.reshape(t, d)
    probs = torch.softmax(xt.float() @ params["router"], dim=-1)  # (T, E)
    cap = capacity(t, top_k, e, capacity_factor)
    sg, stok, se, slot, expert = dispatch(probs, top_k, cap)
    out = _combine(params, xt, sg, stok, se, slot, cap, act)
    return out.reshape(b, s, d).to(x.dtype), _aux_loss(probs, expert)


def _aux_loss(probs: torch.Tensor, expert: torch.Tensor) -> torch.Tensor:
    """Load-balancing aux loss (Switch-style): E * sum_e f_e * p_e."""
    t, e = probs.shape
    density = expert_counts(expert[:, 0], e).float() / t
    return e * torch.sum(density * probs.mean(dim=0))


def _moe_apply_local(params, x: torch.Tensor, *, top_k: int,
                     capacity_factor: float, act: str, par):
    """The reference's per-shard dispatch: the (B * S, D) tokens split
    into n = ``par.axis_size(par.batch_axes_)`` contiguous runs of
    t = B * S / n, one a batch shard (rank order over the batch axes).
    Each shard routes, sorts and clamps its own run with the capacity of
    t tokens; shard r's kept pairs fill slots r * cap .. of each expert's
    row in one (E, n * cap, D) buffer, whose experts run once; each shard
    combines its own pairs.  The aux loss is the shards' mean (a psum
    over the batch axes / n)."""
    b, s, d = x.shape
    e = params["router"].shape[1]
    mesh = par.mesh.sub(par.batch_axes_)
    n = mesh.size
    if (b * s) % n:
        raise ValueError(f"{b * s} tokens do not split over {n} batch "
                         f"shards")
    t = b * s // n
    cap = capacity(t, top_k, e, capacity_factor)
    xt = x.reshape(b * s, d)
    pairs, auxes = [], []
    for r in range(n):
        probs = torch.softmax(xt[r * t:(r + 1) * t].float()
                              @ params["router"], dim=-1)
        sg, stok, se, slot, expert = dispatch(probs, top_k, cap)
        auxes.append(_aux_loss(probs, expert))
        slot = torch.where(slot < e * cap, slot + se * (n - 1) * cap
                           + r * cap, e * n * cap)
        pairs.append((sg, stok + r * t, se, slot))
    sg, stok, se, slot = (torch.cat(p) for p in zip(*pairs))
    # each expert's pairs contiguous (shard by shard) for the passes; a
    # token's pairs keep their order by expert
    order = torch.sort(se, stable=True).indices
    out = _combine(params, xt, sg[order], stok[order], se[order],
                   slot[order], n * cap, act)
    return out.reshape(b, s, d).to(x.dtype), mesh.psum(auxes)[0] / n


def _combine(params, xt, sg, stok, se, slot, cap: int, act: str):
    """The experts on the pairs (sorted by expert) and the float32
    combine into (T, D).  The experts run in passes of at most
    MAX_BUFFER entries of an (experts, cap, width) buffer: one pass at
    the configs' own capacity factors; several where the capacity holds
    every token."""
    t, d = xt.shape
    e, f = params["wi"].shape[0], params["wi"].shape[2]
    per = max(1, MAX_BUFFER // (cap * max(d, f)))
    xs = xt[stok]
    out = torch.zeros((t, d), dtype=torch.float32, device=xt.device)
    # on the meta device (a dry run: shapes only) the bounds cannot be
    # read, and one pass over every expert does the passes' products
    if per >= e or xt.device.type == "meta":
        return out.index_add(0, stok, _experts(params, xs, sg, slot, 0, e,
                                               cap, act))
    # a pass takes the sorted pairs of its experts, a contiguous run
    # (one read of the bounds to the host)
    firsts = torch.arange(0, e + per, per, device=xt.device).clamp(max=e)
    bounds = torch.searchsorted(se, firsts).tolist()
    for i, e0 in enumerate(range(0, e, per)):
        lo, hi = bounds[i], bounds[i + 1]
        if lo == hi:
            continue
        g = min(per, e - e0)
        out = out.index_add(0, stok[lo:hi], _experts(
            params, xs[lo:hi], sg[lo:hi], slot[lo:hi] - e0 * cap, e0, g, cap,
            act))
    return out


def _experts(params, xs, sg, local, e0: int, g: int, cap: int, act: str):
    """Experts e0 .. e0 + g - 1 on sorted pairs' rows ``xs``: each pair
    whose ``local`` slot lies in [0, g * cap) is written once into the
    (g, cap, D) buffer, the rest (dropped) land on an extra row that is
    cut off.  Returns each pair's gate-weighted output, float32 (0 for a
    dropped pair)."""
    d = xs.shape[1]
    local = torch.where((local >= 0) & (local < g * cap), local, g * cap)
    buf = torch.zeros((g * cap + 1, d), dtype=xs.dtype, device=xs.device)
    buf = buf.index_copy(0, local, xs)[:-1].reshape(g, cap, d)
    h = torch.bmm(buf, params["wi"][e0:e0 + g])
    gt = torch.bmm(buf, params["wg"][e0:e0 + g])
    if act == "silu":
        h = F.silu(gt) * h
    else:
        h = torch.square(torch.relu(gt)) * h
    y = torch.bmm(h, params["wo"][e0:e0 + g]).reshape(g * cap, d)
    y = torch.cat([y, y.new_zeros((1, d))])
    return y[local].float() * sg[:, None]
