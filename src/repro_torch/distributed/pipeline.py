"""GPipe-style pipeline parallelism over a mesh axis.

Each shard along ``axis`` owns one STAGE (a slice of layers);
micro-batch activations circulate stage to stage in the reference's
rotating-buffer schedule: step t runs every stage s, on micro-batch
t - s where that exists (other steps compute on what the ring holds and
are discarded); the last stage's outputs are kept from step
n_stages - 1 on, and a ring permute passes each stage's output to the
next.  The pipeline drains after n_micro + n_stages - 1 steps.  Bubble
fraction = (n_stages - 1) / (n_micro + n_stages - 1).

On a single-controller ``ShardMesh`` the stages of a step run one after
another; the permute and the final psum of the last stage's outputs (the
other stages contribute zeros) go through the mesh, as the reference's
``ppermute`` and ``psum`` do.
"""
from __future__ import annotations

from typing import Callable

import torch


def gpipe(stage_fn: Callable, stage_params, xs: torch.Tensor, *, mesh,
          axis: str) -> torch.Tensor:
    """Run a pipelined stack.

    stage_fn(params_one_stage, h) -> h     (same shape in/out)
    stage_params: a dict of tensors with a leading stage dim ==
      ``mesh.shape[axis]`` (the reference's layout), or a sequence of
      one entry a stage (whatever ``stage_fn`` takes).
    xs: (n_micro, mb, ...) micro-batched inputs.
    Returns (n_micro, mb, ...) outputs."""
    ring = mesh.sub(axis)
    n_stages, n_micro = ring.size, xs.shape[0]
    steps = n_micro + n_stages - 1
    perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    if isinstance(stage_params, dict):
        params = [{k: v[s] for k, v in stage_params.items()}
                  for s in range(n_stages)]
    else:
        params = list(stage_params)
        if len(params) != n_stages:
            raise ValueError(f"{len(params)} stages' params for "
                             f"{n_stages} stages")
    h = [torch.zeros_like(xs[0], device=d) for d in ring.devices]
    outs = [[] for _ in range(n_stages)]
    for t in range(steps):
        if t < n_micro:
            h[0] = xs[t].to(ring.devices[0])
        ys = [stage_fn(params[s], h[s]) for s in range(n_stages)]
        if t >= n_stages - 1:
            for s, y in enumerate(ys):
                outs[s].append(y if s == n_stages - 1
                               else torch.zeros_like(y))
        h = ring.ppermute(ys, axis, perm)
    return ring.psum([torch.stack(o) for o in outs], axis)[0]


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)
