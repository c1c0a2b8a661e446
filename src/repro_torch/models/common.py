"""Shared building blocks: norms, RoPE, MLPs, initializers.

The arithmetic of ``repro.models.common``: norms and RoPE in float32,
then cast back to the activation dtype; products in the parameter dtype.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


# a leaf of more float32 entries than this is drawn a slice along its
# first axis at a time, so that its float32 draw never needs a second
# full-size copy on the card (Llama-4 Maverick's (128, 5120, 8192) experts)
DRAW_SLICE = 1 << 30


def dense_init(gen: torch.Generator, shape, in_axis: int = 0,
               scale: float = 1.0, dtype=torch.bfloat16,
               device=None) -> torch.Tensor:
    """Truncated-normal fan-in init, drawn in float32 on ``device`` from
    ``gen`` (a generator on that device), then cast to ``dtype``; a leaf
    above DRAW_SLICE entries is drawn and cast one slice of its first
    axis at a time."""
    std = scale / math.sqrt(shape[in_axis])
    n = math.prod(shape)
    if n <= DRAW_SLICE:
        return _draw(gen, shape, std, dtype, device)
    out = torch.empty(shape, dtype=dtype, device=device)
    rows = max(1, DRAW_SLICE // (n // shape[0]))
    for i in range(0, shape[0], rows):
        out[i:i + rows] = _draw(gen, out[i:i + rows].shape, std, dtype,
                                device)
    return out


def _draw(gen, shape, std, dtype, device) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(std).to(dtype)


def rmsnorm_init(d: int, dtype=torch.bfloat16, device=None) -> torch.Tensor:
    return torch.ones((d,), dtype=dtype, device=device)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, n_heads, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    angles = positions[..., None].float() * freqs            # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                    # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- MLP
def mlp_init(gen: torch.Generator, d: int, f: int, dtype=torch.bfloat16,
             device=None) -> nn.ParameterDict:
    return params_dict(
        wi=dense_init(gen, (d, f), 0, dtype=dtype, device=device),
        wg=dense_init(gen, (d, f), 0, dtype=dtype, device=device),
        wo=dense_init(gen, (f, d), 0, dtype=dtype, device=device))


def mlp_apply(params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    h = x @ params["wi"]
    g = x @ params["wg"]
    if act == "silu":
        h = F.silu(g) * h
    elif act == "relu2":           # squared ReLU (nemotron-4)
        h = torch.square(torch.relu(g)) * h
    else:
        raise ValueError(act)
    return h @ params["wo"]


def mlp_specs(par, stacked: bool = True):
    return {"wi": par.w_col(stacked), "wg": par.w_col(stacked),
            "wo": par.w_row(stacked)}


def params_dict(**tensors: torch.Tensor) -> nn.ParameterDict:
    """Named weights, created without gradients so that serving builds no
    autograd graph; a training state turns them on for the module it
    owns (``train.init_state``, ``interop.train_state_from_numpy``)."""
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tensors.items()})
