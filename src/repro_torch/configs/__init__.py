"""Architecture registry: ``--arch <id>`` resolution for launchers (a
copy of ``repro.configs``)."""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import (ArchConfig, ShapeSpec, SHAPES,
                                      shape_applicable)

_MODULES = {
    "mistral-nemo-12b": "mistral_nemo_12b",
    "nemotron-4-15b": "nemotron_4_15b",
    "yi-6b": "yi_6b",
    "gemma3-27b": "gemma3_27b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "whisper-small": "whisper_small",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "llama4-maverick-400b-a17b": "llama4_maverick",
    "zamba2-1.2b": "zamba2_1p2b",
    "llama-3.2-vision-11b": "llama32_vision_11b",
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ArchConfig:
    import importlib
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def reduced_config(cfg: ArchConfig, *, d_model: int = 64,
                   n_layers: int | None = None, vocab: int = 512,
                   d_ff: int = 128) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests.

    Keeps the block pattern (one repeat + tail) and all structural
    features (GQA ratio, MoE top-k, SSM version, cross-attn) while
    shrinking every width.
    """
    pat = cfg.pattern
    n_rep = 1
    layers = len(pat) * n_rep + len(cfg.tail)
    heads = max(2, min(cfg.n_heads, 4))
    kv = max(1, heads * cfg.n_kv_heads // cfg.n_heads)
    changes = dict(
        n_layers=layers, d_model=d_model, n_heads=heads, n_kv_heads=kv,
        d_ff=d_ff if cfg.d_ff else 0, vocab=vocab, head_dim=0,
        repeats=n_rep, sliding_window=8,
    )
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe, num_experts=min(cfg.moe.num_experts, 8),
            top_k=min(cfg.moe.top_k, 2))
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=8, head_dim=16, chunk=8)
    if cfg.encoder_layers:
        changes["encoder_layers"] = 2
        changes["encoder_seq"] = 16
    if cfg.num_image_tokens:
        changes["num_image_tokens"] = 16
    return dataclasses.replace(cfg, **changes)


__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "ARCH_NAMES", "get_config",
           "reduced_config", "shape_applicable"]
