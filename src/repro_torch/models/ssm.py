"""Mamba-1 and Mamba-2 (SSD) blocks, one device.

No (B, S, d_inner, d_state) tensor of the whole sequence: sequences are
processed in chunks, a Python loop over them carrying the float32
state.

  * Mamba-1: within a chunk, a log-depth (Hillis-Steele) scan over the
    chunk's time steps of the diagonal recurrence
    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t, combining
    (a_l, b_l), (a_r, b_r) -> (a_l a_r, a_r b_l + b_r) as the
    reference's ``lax.associative_scan`` does: no exp of a positive
    cumsum.  Its float32 additions run in another order than XLA's.
  * Mamba-2: the SSD matmul form, an intra-chunk decay-masked C B^T
    product and the inter-chunk state recurrence.

``remat`` runs each chunk step under ``torch.utils.checkpoint``.  Decode
is the O(1) single-step recurrence: the conv window and the SSM state
are the whole cache.  The arithmetic of ``repro.models.ssm``: A_log, D
and dt_bias are float32 leaves in any model, the scans run in float32.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import dense_init, params_dict, rmsnorm


# --------------------------------------------------------------- params
def init_mamba1(gen: torch.Generator, d_model: int, d_state: int,
                expand: int, d_conv: int, dt_rank: int,
                dtype=torch.bfloat16, device=None):
    di = expand * d_model
    dtr = dt_rank or -(-d_model // 16)
    a = torch.arange(1, d_state + 1, dtype=torch.float32,
                     device=device).repeat(di, 1)
    return params_dict(
        in_proj=dense_init(gen, (d_model, 2 * di), 0, dtype=dtype,
                           device=device),
        conv_w=dense_init(gen, (d_conv, di), 0, dtype=dtype, device=device),
        conv_b=torch.zeros((di,), dtype=dtype, device=device),
        x_proj=dense_init(gen, (di, dtr + 2 * d_state), 0, dtype=dtype,
                          device=device),
        dt_proj=dense_init(gen, (dtr, di), 0, dtype=dtype, device=device),
        dt_bias=torch.full((di,), -4.6, dtype=torch.float32,
                           device=device),             # softplus ~ 0.01
        A_log=torch.log(a),
        D=torch.ones((di,), dtype=torch.float32, device=device),
        out_proj=dense_init(gen, (di, d_model), 0, dtype=dtype,
                            device=device))


def mamba1_specs(par, stacked: bool = True):
    st = (None,) if stacked else ()
    ma = par.model_axis if par.active else None
    fa = par.fsdp_axis()
    return {"in_proj": st + (fa, ma), "conv_w": st + (None, ma),
            "conv_b": st + (ma,), "x_proj": st + (ma, None),
            "dt_proj": st + (None, ma), "dt_bias": st + (ma,),
            "A_log": st + (ma, None), "D": st + (ma,),
            "out_proj": st + (ma, fa)}


def init_mamba2(gen: torch.Generator, d_model: int, d_state: int,
                expand: int, d_conv: int, head_dim: int,
                dtype=torch.bfloat16, device=None):
    di = expand * d_model
    nh = di // head_dim
    d_in = 2 * di + 2 * d_state + nh
    return params_dict(
        in_proj=dense_init(gen, (d_model, d_in), 0, dtype=dtype,
                           device=device),
        conv_w=dense_init(gen, (d_conv, di + 2 * d_state), 0, dtype=dtype,
                          device=device),
        conv_b=torch.zeros((di + 2 * d_state,), dtype=dtype, device=device),
        A_log=torch.zeros((nh,), dtype=torch.float32, device=device),
        dt_bias=torch.full((nh,), -4.6, dtype=torch.float32, device=device),
        D=torch.ones((nh,), dtype=torch.float32, device=device),
        gate_norm=torch.ones((di,), dtype=dtype, device=device),
        out_proj=dense_init(gen, (di, d_model), 0, dtype=dtype,
                            device=device))


# ----------------------------------------------------------------- conv
def mamba2_specs(par, stacked: bool = True):
    st = (None,) if stacked else ()
    ma = par.model_axis if par.active else None
    fa = par.fsdp_axis()
    return {"in_proj": st + (fa, ma), "conv_w": st + (None, ma),
            "conv_b": st + (ma,), "A_log": st + (ma,),
            "dt_bias": st + (ma,), "D": st + (ma,),
            "gate_norm": st + (ma,), "out_proj": st + (ma, fa)}


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
    """Depthwise causal conv as kernel-size shifts, in float32.
    x: (B, S, C); w: (k, C); b: (C,)."""
    k, s = w.shape[0], x.shape[1]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        shift = k - 1 - i
        xi = F.pad(x, (0, 0, shift, 0))[:, :s]
        out = out + xi.float() * w[i].float()
    return (out + b.float()).to(x.dtype)


def conv_step(x_new: torch.Tensor, conv_state: torch.Tensor,
              w: torch.Tensor, b: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step.  x_new: (B, C); conv_state: (B, k-1, C) ->
    (y (B, C), the new state)."""
    full = torch.cat([conv_state, x_new[:, None].to(conv_state.dtype)],
                     dim=1)                                  # (B, k, C)
    y = torch.einsum("bkc,kc->bc", full.float(), w.float()) + b.float()
    return y.to(x_new.dtype), full[:, 1:]


def conv_tail(x: torch.Tensor, k: int) -> torch.Tensor:
    """The last k - 1 rows of (B, S, C) ``x``, zeros before the start:
    the conv state a prefill of S tokens leaves."""
    return F.pad(x, (0, 0, max(0, k - 1 - x.shape[1]), 0))[:, -(k - 1):]


def _divisor_chunk(s: int, c: int) -> int:
    """The largest divisor of ``s`` that is at most ``c``."""
    for d in range(min(c, s), 0, -1):
        if s % d == 0:
            return d
    return 1


def _chunks(t: torch.Tensor, k: int):
    """(B, S, ...) float32 -> the S / k chunks (B, k, ...) in order."""
    return t.float().split(k, dim=1)


# -------------------------------------------------------------- mamba-1
def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of h_t = a_t h_{t-1} + b_t (h_{-1} = 0) over dim 1,
    in log2(K) Hillis-Steele rounds of the reference's combine.  Returns
    the h_t."""
    k = a.shape[1]
    off = 1
    while off < k:
        nb = b.clone()
        nb[:, off:].addcmul_(a[:, off:], b[:, :-off])
        b = nb
        if 2 * off < k:                   # the last round needs no a
            na = a.clone()
            na[:, off:].mul_(a[:, :-off])
            a = na
        off *= 2
    return b


def _mamba1_step(h, xk, dtk, bk, ck, a_neg):
    """One chunk: (B, di, N) state and (B, K, di) / (B, K, N) inputs ->
    (the chunk's last state, y (B, K, di))."""
    decay = torch.exp(dtk[..., None] * a_neg)                # (B,K,di,N)
    u = (dtk * xk)[..., None] * bk[:, :, None, :]
    u[:, 0].addcmul_(decay[:, 0], h)
    hs = linear_scan(decay, u)
    y = torch.einsum("bkdn,bkn->bkd", hs, ck)
    return hs[:, -1], y


def mamba1_scan(xb, dt, bmat, cmat, a_neg, h0, chunk: int,
                remat: bool = False):
    """Chunked selective scan.

    xb, dt: (B, S, di); bmat, cmat: (B, S, N); a_neg: (di, N) (negative);
    h0: (B, di, N).  Returns (y (B, S, di), h_final), float32."""
    k = _divisor_chunk(xb.shape[1], chunk)
    h = h0.float()
    ys = []
    for xk, dtk, bk, ck in zip(*(_chunks(t, k) for t in
                                 (xb, dt, bmat, cmat))):
        if remat:
            h, y = checkpoint(_mamba1_step, h, xk, dtk, bk, ck, a_neg,
                              use_reentrant=False)
        else:
            h, y = _mamba1_step(h, xk, dtk, bk, ck, a_neg)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def mamba1_block(params, x: torch.Tensor, *, d_state: int, chunk: int,
                 dt_rank: int, return_state: bool = False,
                 remat: bool = False):
    """Full Mamba-1 mixer.  x: (B, S, D) -> (B, S, D).

    With ``return_state`` also returns the decode state
    {"conv": (B, k-1, di) pre-conv inputs, "ssm": (B, di, N)}."""
    b, s, _ = x.shape
    di = params["D"].shape[0]
    dtr = dt_rank
    xz = x @ params["in_proj"]
    xb_raw, z = xz.split(di, dim=-1)
    xb = F.silu(causal_conv(xb_raw, params["conv_w"], params["conv_b"]))
    proj = xb @ params["x_proj"]                             # (B,S,dtr+2N)
    dt_low = proj[..., :dtr]
    bmat = proj[..., dtr:dtr + d_state].float()
    cmat = proj[..., dtr + d_state:].float()
    dt = F.softplus((dt_low @ params["dt_proj"]).float() + params["dt_bias"])
    a_neg = -torch.exp(params["A_log"])
    h0 = torch.zeros((b, di, d_state), dtype=torch.float32, device=x.device)
    y, h_final = mamba1_scan(xb, dt, bmat, cmat, a_neg, h0, chunk,
                             remat=remat)
    y = y + params["D"] * xb.float()
    y = (y * F.silu(z.float())).to(x.dtype)
    out = y @ params["out_proj"]
    if return_state:
        k = params["conv_w"].shape[0]
        return out, {"conv": conv_tail(xb_raw, k), "ssm": h_final}
    return out


def mamba1_decode(params, x_tok: torch.Tensor, state: dict, *, d_state: int,
                  dt_rank: int) -> Tuple[torch.Tensor, dict]:
    """One step.  x_tok: (B, D); state {"conv": (B, k-1, di), "ssm":
    (B, di, N)} -> (out (B, D), the new state)."""
    di = params["D"].shape[0]
    xz = x_tok @ params["in_proj"]
    xb, z = xz.split(di, dim=-1)
    xb, conv_state = conv_step(xb, state["conv"], params["conv_w"],
                               params["conv_b"])
    xb = F.silu(xb)
    proj = xb @ params["x_proj"]
    dtr = dt_rank
    dt = F.softplus((proj[..., :dtr] @ params["dt_proj"]).float()
                    + params["dt_bias"])                      # (B, di)
    bm = proj[..., dtr:dtr + d_state].float()                 # (B, N)
    cm = proj[..., dtr + d_state:].float()
    a_neg = -torch.exp(params["A_log"])                       # (di, N)
    h = state["ssm"] * torch.exp(dt[..., None] * a_neg) \
        + (dt * xb.float())[..., None] * bm[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, cm) + params["D"] * xb.float()
    y = (y * F.silu(z.float())).to(x_tok.dtype)
    return y @ params["out_proj"], {"conv": conv_state, "ssm": h}


# -------------------------------------------------------------- mamba-2
def _ssd_step(h, xk, dtk, bk, ck, a_neg):
    """One chunk: (B, nh, P, N) state and (B, K, nh, P), (B, K, nh),
    (B, K, N) inputs -> (the chunk's last state, y (B, K, nh, P))."""
    k = xk.shape[1]
    tri = torch.tril(torch.ones((k, k), dtype=torch.bool,
                                device=xk.device))[None, ..., None]
    da = dtk * a_neg                                          # (B,K,nh)
    cum = torch.cumsum(da, dim=1)
    # intra-chunk: the decay-masked C B^T product
    cb = torch.einsum("btn,bsn->bts", ck, bk)                 # (B,K,K)
    diff = cum[:, :, None, :] - cum[:, None, :, :]            # (B,K,K,nh)
    w = cb[..., None] * torch.exp(torch.where(tri, diff, 0.0))
    w = torch.where(tri, w, 0.0)
    xdt = xk * dtk[..., None]                                 # (B,K,nh,P)
    y_intra = torch.einsum("btsh,bshp->bthp", w, xdt)
    # inter-chunk: the carried state's contribution
    y_inter = torch.einsum("btn,bhpn,bth->bthp", ck, h, torch.exp(cum))
    rem = torch.exp(cum[:, -1:, :] - cum)                     # (B,K,nh)
    h_new = h * torch.exp(cum[:, -1])[:, :, None, None] \
        + torch.einsum("bshp,bsn,bsh->bhpn", xdt, bk, rem)
    return h_new, y_intra + y_inter


def ssd_scan(x, dt, bmat, cmat, a_neg, h0, chunk: int,
             remat: bool = False):
    """SSD chunked scan (Mamba-2).

    x: (B, S, nh, P); dt: (B, S, nh); bmat, cmat: (B, S, N); a_neg:
    (nh,); h0: (B, nh, P, N).  Returns (y (B, S, nh, P), h_final),
    float32."""
    k = _divisor_chunk(x.shape[1], chunk)
    h = h0.float()
    ys = []
    for xk, dtk, bk, ck in zip(*(_chunks(t, k) for t in
                                 (x, dt, bmat, cmat))):
        if remat:
            h, y = checkpoint(_ssd_step, h, xk, dtk, bk, ck, a_neg,
                              use_reentrant=False)
        else:
            h, y = _ssd_step(h, xk, dtk, bk, ck, a_neg)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def mamba2_block(params, x: torch.Tensor, *, d_state: int, head_dim: int,
                 chunk: int, norm_eps: float = 1e-5,
                 return_state: bool = False, remat: bool = False):
    """Full Mamba-2 mixer.  x: (B, S, D) -> (B, S, D).

    With ``return_state`` also returns the decode state
    {"conv": (B, k-1, di + 2N) pre-conv inputs, "ssm": (B, nh, P, N)}."""
    b, s, _ = x.shape
    nh = params["A_log"].shape[0]
    di = nh * head_dim
    proj = x @ params["in_proj"]
    z = proj[..., :di]
    xbc_raw = proj[..., di:di + di + 2 * d_state]
    dt_raw = proj[..., -nh:]
    xbc = F.silu(causal_conv(xbc_raw, params["conv_w"], params["conv_b"]))
    xb = xbc[..., :di].reshape(b, s, nh, head_dim)
    bmat = xbc[..., di:di + d_state].float()
    cmat = xbc[..., di + d_state:].float()
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    a_neg = -torch.exp(params["A_log"])
    h0 = torch.zeros((b, nh, head_dim, d_state), dtype=torch.float32,
                     device=x.device)
    y, h_final = ssd_scan(xb, dt, bmat, cmat, a_neg, h0, chunk, remat=remat)
    y = y + params["D"][:, None] * xb.float()
    y = y.reshape(b, s, di)
    y = rmsnorm(y * F.silu(z.float()), params["gate_norm"],
                norm_eps).to(x.dtype)
    out = y @ params["out_proj"]
    if return_state:
        k = params["conv_w"].shape[0]
        return out, {"conv": conv_tail(xbc_raw, k), "ssm": h_final}
    return out


def mamba2_decode(params, x_tok: torch.Tensor, state: dict, *, d_state: int,
                  head_dim: int, norm_eps: float = 1e-5
                  ) -> Tuple[torch.Tensor, dict]:
    """One step.  state {"conv": (B, k-1, di + 2N), "ssm": (B, nh, P, N)}
    -> (out (B, D), the new state)."""
    nh = params["A_log"].shape[0]
    di = nh * head_dim
    b = x_tok.shape[0]
    proj = x_tok @ params["in_proj"]
    z = proj[..., :di]
    xbc = proj[..., di:di + di + 2 * d_state]
    dt_raw = proj[..., -nh:]
    xbc, conv_state = conv_step(xbc, state["conv"], params["conv_w"],
                                params["conv_b"])
    xbc = F.silu(xbc)
    xb = xbc[..., :di].reshape(b, nh, head_dim).float()
    bm = xbc[..., di:di + d_state].float()
    cm = xbc[..., di + d_state:].float()
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    a_neg = -torch.exp(params["A_log"])
    h = state["ssm"] * torch.exp(dt * a_neg)[..., None, None] \
        + torch.einsum("bhp,bn,bh->bhpn", xb, bm, dt)
    y = torch.einsum("bhpn,bn->bhp", h, cm) + params["D"][:, None] * xb
    y = y.reshape(b, di)
    y = rmsnorm(y * F.silu(z.float()), params["gate_norm"],
                norm_eps).to(x_tok.dtype)
    return y @ params["out_proj"], {"conv": conv_state, "ssm": h}
