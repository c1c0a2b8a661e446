"""Per-(arch x shape x mesh) parallelism policy and abstract inputs.

``input_specs`` returns meta-device stand-ins for every input of a
cell's step (weights, optimizer state, KV caches, token batches), so
that the dry run runs the step with no allocation, and the spec tuple of
each of their leaves.  The port's trees keep its own layout (the
``Transformer``'s named parameters, moments keyed like them, one cache
dict a layer in execution order); ``to_shardings`` reads each leaf's
spec off the reference's spec trees (``param_specs``, ``state_specs``,
``batch_specs``; the caches ``layer_cache_specs``).
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core.distributed import ShardMesh
from repro_torch.models import init_caches, init_params, param_specs
from repro_torch.models.parallel import ParallelConfig, shard_shape
from repro_torch.models.transformer import layer_cache_specs
from repro_torch.train.step import (TrainConfig, batch_specs, init_state,
                                    named_specs, state_specs)

__all__ = ["make_par", "abstract_state", "abstract_params",
           "abstract_caches", "to_shardings", "input_specs",
           "input_bytes_per_device"]

META = torch.device("meta")


def make_par(mesh: ShardMesh, multi_pod: bool, cfg: ArchConfig,
             shape: ShapeSpec, **overrides) -> ParallelConfig:
    """The sharding policy for one dry-run cell (the reference's)."""
    daxes = ("pod", "data") if multi_pod else ("data",)
    n_batch_shards = 1
    for a in daxes:
        n_batch_shards *= mesh.shape[a]

    kw: Dict[str, Any] = dict(mesh=mesh, data_axes=daxes, seq_shard=True,
                              fsdp=True, remat="block")
    if shape.kind == "decode":
        kw["remat"] = "none"
        if shape.global_batch >= n_batch_shards:
            # batch over data axes, cache seq over model axis
            kw["decode_seq_shard"] = ("model",)
        else:
            # global_batch=1 (long_500k): replicate batch, shard the
            # cache sequence over EVERY axis; fsdp still on data axes.
            kw["batch_axes"] = ()
            kw["decode_seq_shard"] = daxes + ("model",)
    elif shape.kind == "prefill":
        kw["remat"] = "none"
    kw.update(overrides)
    return ParallelConfig(**kw)


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _batch_struct(cfg: ArchConfig, b: int, s: int, with_labels: bool):
    out = {"tokens": _sds((b, s), torch.int32)}
    if with_labels:
        out["labels"] = _sds((b, s), torch.int32)
    if cfg.encoder_layers:
        out["frames"] = _sds((b, cfg.encoder_seq, cfg.d_model),
                             torch.bfloat16)
    if cfg.num_image_tokens:
        out["image_embeds"] = _sds((b, cfg.num_image_tokens, cfg.d_model),
                                   torch.bfloat16)
    return out


def abstract_state(cfg: ArchConfig, tcfg: TrainConfig = TrainConfig()):
    return init_state(cfg, 0, tcfg, device=META)


def abstract_params(cfg: ArchConfig):
    return init_params(cfg, 0, device=META)


def abstract_caches(cfg: ArchConfig, b: int, cache_len: int,
                    par: ParallelConfig):
    mem_len = cfg.encoder_seq or cfg.num_image_tokens
    return init_caches(cfg, b, cache_len, device=META, memory_len=mem_len)


def to_shardings(abstract_tree, spec_tree, cfg: ArchConfig):
    """``abstract_tree`` (the port's layout) with each leaf replaced by its
    spec tuple from ``spec_tree`` (the reference's layout): a
    ``Transformer`` becomes {parameter name: spec}, moments keyed like it
    take their parameter's spec; other dicts map key by key, a tensor
    takes its spec.  (Caches take ``layer_cache_specs``.)"""
    if isinstance(abstract_tree, nn.Module):
        return named_specs(spec_tree,
                           dict(abstract_tree.named_parameters()), cfg)
    if isinstance(abstract_tree, torch.Tensor):
        return tuple(spec_tree)
    if "embed" in spec_tree:           # moments keyed like the parameters
        return named_specs(spec_tree, abstract_tree, cfg)
    return {k: to_shardings(v, spec_tree[k], cfg)
            for k, v in abstract_tree.items()}


def input_specs(cfg: ArchConfig, shape: ShapeSpec, par: ParallelConfig,
                tcfg: TrainConfig = TrainConfig()):
    """(args, in specs, out specs) of the cell's step, the args on the
    meta device; prefill's caches are outputs, as in the reference."""
    b, s = shape.global_batch, shape.seq_len
    tok_sp = (par.batch(),)
    if shape.kind == "train":
        st = abstract_state(cfg, tcfg)
        ba = _batch_struct(cfg, b, s, with_labels=True)
        st_sp = to_shardings(st, state_specs(cfg, par, tcfg), cfg)
        ba_sp = to_shardings(ba, batch_specs(cfg, par), cfg)
        return (st, ba), (st_sp, ba_sp), (st_sp, None)
    if shape.kind == "prefill":
        pa = abstract_params(cfg)
        ba = _batch_struct(cfg, b, s, with_labels=False)
        pa_sp = to_shardings(pa, param_specs(cfg, par), cfg)
        bspec = {"tokens": (par.batch(), None)}
        if cfg.encoder_layers:
            bspec["frames"] = (par.batch(), None, None)
        if cfg.num_image_tokens:
            bspec["image_embeds"] = (par.batch(), None, None)
        ca_sp = {"blocks": layer_cache_specs(cfg, par)}
        return (pa, ba), (pa_sp, bspec), (tok_sp, ca_sp, tok_sp)
    # decode
    pa = abstract_params(cfg)
    ca = abstract_caches(cfg, b, s, par)
    tok = _sds((b,), torch.int32)
    lens = _sds((b,), torch.int32)
    pa_sp = to_shardings(pa, param_specs(cfg, par), cfg)
    ca_sp = {"blocks": layer_cache_specs(cfg, par)}
    return ((pa, ca, tok, lens), (pa_sp, ca_sp, tok_sp, tok_sp),
            (tok_sp, ca_sp, tok_sp))


def input_bytes_per_device(args, specs, mesh: ShardMesh) -> int:
    """The bytes of one device's shard of every input (the reference's
    ``_leaf_bytes`` sum): each leaf's ``shard_shape`` under its spec.
    Raises ``ValueError`` where a leaf does not split evenly."""
    if isinstance(args, torch.Tensor):
        return (math.prod(shard_shape(args.shape, specs, mesh))
                * args.element_size())
    if isinstance(args, nn.Module):
        args = dict(args.named_parameters())
    if isinstance(args, dict):
        return sum(input_bytes_per_device(v, specs[k], mesh)
                   for k, v in args.items())
    return sum(input_bytes_per_device(a, s, mesh)
               for a, s in zip(args, specs, strict=True))
