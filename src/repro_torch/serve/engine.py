"""Serving engine: prefill/decode step factories + generation loop.

``make_serve_prefill`` / ``make_serve_step`` build the functions one
generation step runs: the prompt's prefill (then its first greedy
token), and one new token for the whole batch against the decode
caches, which the step updates in place.  A batch of an audio or vision
config carries its stub ``frames`` or ``image_embeds``: the prefill
encodes them once, and decode reads their K/V from the caches.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.index import resolve_device
from repro_torch.models import decode_step, prefill
from repro_torch.models.embedding import greedy_sample
from repro_torch.models.parallel import ParallelConfig


def make_serve_prefill(cfg: ArchConfig, par: ParallelConfig,
                       cache_len: int):
    def serve_prefill(params, batch):
        h_last, caches, lengths = prefill(params, batch, cfg, par,
                                          cache_len)
        token = greedy_sample(params.lm_head, h_last, par)
        return token, caches, lengths
    return serve_prefill


def make_serve_step(cfg: ArchConfig, par: ParallelConfig):
    def serve_step(params, caches, token, lengths):
        h_last, caches = decode_step(params, caches, token, lengths, cfg,
                                     par)
        nxt = greedy_sample(params.lm_head, h_last, par)
        return nxt, caches, lengths + 1
    return serve_step


def generate(params, batch, cfg: ArchConfig, par: ParallelConfig, *,
             cache_len: int, max_new_tokens: int,
             eos_id: Optional[int] = None, device=None) -> torch.Tensor:
    """Greedy generation for a batch of equal-length prompts on
    ``device`` (None: the GPU), where ``params`` must live.

    Returns (B, max_new_tokens) int32; with ``eos_id``, fewer columns
    when every row has emitted it."""
    device = resolve_device(device)
    if params.device.type != device.type:
        raise ValueError(f"params live on {params.device}, not {device}")
    pre = make_serve_prefill(cfg, par, cache_len)
    step = make_serve_step(cfg, par)
    with torch.inference_mode():
        token, caches, lengths = pre(params, batch)
        out = [token]
        for _ in range(max_new_tokens - 1):
            token, caches, lengths = step(params, caches, token, lengths)
            out.append(token)
            if eos_id is not None and bool((token == eos_id).all()):
                break
        return torch.stack(out, dim=1)
