"""Meshes of the launchers.  Functions, not module constants: importing
this module touches no device.

A mesh is a single-controller ``core.distributed.ShardMesh`` of named
axes.  ``make_debug_mesh`` puts every shard on one device (the card,
unless the caller asks for the CPU), where the model code keeps its
tensors whole and runs each shard's part in turn; the production meshes
are of the meta device, for counting shapes and bytes without
allocating anything.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.core.distributed import ShardMesh
from repro_torch.core.index import resolve_device


def make_production_mesh(*, multi_pod: bool = False, device="meta"
                         ) -> ShardMesh:
    """16 x 16 = 256 shards a pod; 2 pods = 512 shards with a 'pod'
    axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return ShardMesh([torch.device(device)] * math.prod(shape), axes, shape)


def make_debug_mesh(shape: Tuple[int, ...] = (2, 2),
                    axes: Tuple[str, ...] = ("data", "model"),
                    device="cuda") -> ShardMesh:
    """A small mesh with every shard on ``device`` ("cuda": the current
    card; raises without CUDA)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return ShardMesh([dev] * math.prod(shape), tuple(axes), tuple(shape))


def data_axes(multi_pod: bool) -> Tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)
