"""AdamW with bf16 params / f32 moments.

The moments are float32 whatever the parameters' dtype (the
mixed-precision convention).  ``update`` works in place under
``torch.no_grad()`` — the counterpart of the reference's donated state —
in the reference's order of operations, in float32, each parameter cast
back to its own dtype at the end; a large leaf a slice of rows at a
time (elementwise, so the same values).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch


# entries a slice of a leaf's elementwise update (``slices``)
SLICE = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1


def init(params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Zero float32 moments keyed like ``params``, and an int32 0-d step
    on their device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = next(iter(params.values())).device
    return {"m": {k: zeros(p) for k, p in params.items()},
            "v": {k: zeros(p) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
def update(grads: Dict[str, torch.Tensor], opt_state: Dict[str, Any],
           params: Dict[str, torch.Tensor], lr,
           cfg: AdamWConfig = AdamWConfig()):
    """One step: ``params``, the moments and the step, in place;
    returns (params, opt_state), the same objects.

    ``lr`` is a float or a float32 0-d tensor.  The bias corrections
    ``1 - b ** t`` are float32 powers of the float32 step, as the
    reference's."""
    step = opt_state["step"].add_(1)
    t = step.to(torch.float32)
    c1 = 1.0 - cfg.b1 ** t
    c2 = 1.0 - cfg.b2 ** t
    for k, p in params.items():
        for g, m, v, ps in zip(*(slices(t) for t in (
                grads[k], opt_state["m"][k], opt_state["v"][k], p))):
            g = g.float()
            m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
            del g
            pf = ps.float()
            u = (m / c1).div_(torch.sqrt(v / c2).add_(cfg.eps))
            u.add_(cfg.weight_decay * pf)
            ps.copy_(pf - lr * u)
    return params, opt_state


def slices(t: torch.Tensor):
    """Views of ``t`` along its first axis of at most SLICE entries each
    (``t`` itself when it has no more): the elementwise updates' float32
    temporaries stay that small (a 262,144 x 5,376 table would need about
    five 5.6 GB ones at once)."""
    n = t.numel()
    if n <= SLICE or t.ndim == 0:
        return [t]
    rows = max(1, SLICE // (n // t.shape[0]))
    return list(t.split(rows))
