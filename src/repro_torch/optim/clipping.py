"""Global-norm gradient clipping over a dict of name -> tensor."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.optim.adamw import slices


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the float32 sum of squares of every leaf (a 0-d tensor);
    a large leaf summed a slice of rows at a time (``adamw.slices``)."""
    return torch.sqrt(sum(torch.sum(torch.square(s.float()))
                          for x in tree.values() for s in slices(x)))


def clip_by_global_norm_(grads: Dict[str, torch.Tensor], max_norm: float
                         ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """``clip_by_global_norm`` that replaces the entries of ``grads``
    itself, one at a time, so that each old grad is freed before the
    next is scaled (the caller holding no other reference): a training
    step never holds two copies of its grads."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for k, g in grads.items():
        out = torch.empty_like(g)         # a slice of rows at a time
        for o, s in zip(slices(out), slices(g)):
            o.copy_(s.float() * scale)
        grads[k] = out
    return grads, norm


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """(grads scaled by min(1, max_norm / norm), norm), a new dict: each
    grad is scaled in float32 and cast back to its own dtype."""
    return clip_by_global_norm_(dict(grads), max_norm)
