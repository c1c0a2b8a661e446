"""Carry the reference's random draws and tables into the port.

Takes numpy arrays only, so a test can hand the port the exact family
parameters (and even the exact CSR tables) of a ``repro`` index, or the
exact weights of a ``repro`` model, without relying on two random number
generators agreeing.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.lsh.tables import LSHTables

__all__ = ["params_from_numpy", "tables_from_numpy", "dynamic_index_from_state",
           "sharded_index_from_state", "model_params_from_numpy",
           "train_state_from_numpy"]


def _tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.array(a)                  # a writable copy (JAX arrays are not)
    if a.dtype == np.uint32:         # torch's CPU ops want a signed view
        a = a.astype(np.int64)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


_PARAM_DTYPES = {"R": torch.float32, "a": torch.float32, "b": torch.float32,
                 "pos": torch.int32}


def params_from_numpy(params: Dict[str, np.ndarray],
                      device) -> Dict[str, torch.Tensor]:
    """Family params (``R`` for SimHash, ``a``/``b`` for the p-stable
    families, ``pos`` for BitSampling) as tensors on ``device``."""
    unknown = set(params) - set(_PARAM_DTYPES)
    if unknown:
        raise KeyError(f"unknown family params {sorted(unknown)}")
    return {k: _tensor(v, _PARAM_DTYPES[k], device)
            for k, v in params.items()}


def tables_from_numpy(perm, starts, registers, device) -> LSHTables:
    """Built CSR tables and HLL registers as an ``LSHTables`` on
    ``device``: perm (L, n) and starts (L, B + 1) int32, registers
    (L, B, m) uint8."""
    return LSHTables(_tensor(perm, torch.int32, device),
                     _tensor(starts, torch.int32, device),
                     _tensor(registers, torch.uint8, device))


def dynamic_index_from_state(family, state, device, **kwargs):
    """A port ``DynamicHybridIndex`` holding a reference index's
    ``state_dict()`` (its params included); ``kwargs`` as the
    constructor's (``num_buckets``, ``m``, ``cap``, ...)."""
    from repro_torch.streaming.index import DynamicHybridIndex
    return DynamicHybridIndex(family, params=params_from_numpy(
        {k: np.asarray(v) for k, v in state["params"].items()}, device),
        device=device, **kwargs).load_state_dict(state)


def sharded_index_from_state(family, state, mesh, **kwargs):
    """A port ``ShardedDynamicHybridIndex`` on ``mesh`` holding a
    reference sharded index's ``state_dict()`` (leaves as numpy, its
    params included); a state saved on another shard count re-deals its
    rows onto the mesh.  ``kwargs`` as the constructor's."""
    from repro_torch.streaming.sharded import ShardedDynamicHybridIndex
    return ShardedDynamicHybridIndex(family, mesh=mesh, params=params_from_numpy(
        {k: np.asarray(v) for k, v in state["params"].items()},
        mesh.devices[0]), **kwargs).load_state_dict(state)


def model_params_from_numpy(params, cfg, device):
    """A port ``Transformer`` on ``device`` holding the weights of the
    reference's ``init_params(cfg, key)`` pytree (leaves as numpy, e.g.
    float32 copies of bf16 weights: bf16 -> f32 -> bf16 is exact), cast
    to ``cfg.param_dtype`` (``FLOAT32_LEAVES``, the router and the SSM's
    A_log, D and dt_bias, stay float32).  The ``(repeats, ...)`` leaves
    of ``params["blocks"]`` are unstacked into per-layer modules in the
    reference's execution order: repeat by repeat, pattern position by
    pattern position, then the tail; the encoder's ``(encoder_layers,
    ...)`` leaves likewise; ``shared`` and ``img_proj`` as they are."""
    from repro_torch.models.transformer import FLOAT32_LEAVES, from_leaves
    dt = cfg.param_dtype

    def leaf(a, name=""):
        return _tensor(np.asarray(a, np.float32),
                       torch.float32 if name in FLOAT32_LEAVES else dt,
                       device)

    def layer(tree, i=None):
        return {k: ({kk: leaf(vv if i is None else vv[i], kk)
                     for kk, vv in v.items()} if isinstance(v, dict)
                    else leaf(v if i is None else v[i], k))
                for k, v in tree.items()}

    tree = {"embed": leaf(params["embed"]),
            "final_norm": leaf(params["final_norm"]),
            "lm_head": leaf(params["lm_head"]),
            "layers": [layer(params["blocks"][pos], i)
                       for i in range(cfg.n_repeats)
                       for pos in range(len(cfg.pattern))]
            + [layer(t) for t in params["tail"]]}
    if "shared" in params:
        tree["shared"] = layer(params["shared"])
    if "encoder" in params:
        enc = params["encoder"]
        tree["encoder"] = {"blocks": [layer(enc["blocks"], i)
                                      for i in range(cfg.encoder_layers)],
                           "final_norm": leaf(enc["final_norm"])}
    if "img_proj" in params:
        tree["img_proj"] = leaf(params["img_proj"])
    return from_leaves(cfg, tree)


def train_state_from_numpy(state, cfg, device):
    """A port training state on ``device`` holding the reference's
    ``init_state`` pytree ``{"params", "opt": {"m", "v", "step"}}``
    (leaves as numpy): the weights as ``model_params_from_numpy`` gives
    them, made trainable, and the float32 moments unstacked the same
    way (``train.load_state_tree``)."""
    from repro_torch.optim import adamw_init
    from repro_torch.train.step import load_state_tree
    params = model_params_from_numpy(state["params"], cfg,
                                     device).requires_grad_(True)
    out = {"params": params,
           "opt": adamw_init(dict(params.named_parameters()))}
    return load_state_tree(out, state, cfg)
