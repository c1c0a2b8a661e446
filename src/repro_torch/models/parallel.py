"""Parallelism context threaded through the model zoo.

Model code never hardcodes a mesh: it receives a ``ParallelConfig``.  Axis
roles, as in ``repro.models.parallel``:

  data axes   ('pod', 'data') or ('data',)  -- batch / fsdp axis
  model axis  'model'                        -- tensor / expert parallel

Weight layout is FSDP + TP: 2-D weights are (fsdp axis, 'model') with
'model' on the contracted-out ("parallel") dim; stacked block weights
prepend None.  Activations are (data axes, 'model', None) between blocks
when ``seq_shard`` (Megatron-style sequence parallelism) is on.  A spec
is a tuple with one entry a leading dim: None, an axis name, or a tuple
of names (the reference's ``PartitionSpec`` entries).

The mesh is a single-controller ``core.distributed.ShardMesh`` whose
shards all lie on one device, and model tensors stay whole on it.  So
``shard(x, *spec)`` checks the spec against the tensor (no more entries
than dims, every name an axis of the mesh, none twice) and returns ``x``
unchanged: a layout constraint moves no numbers, on one controller as in
the reference's GSPMD.  What a mesh does change is computed where the
reference runs a ``shard_map``: the vocab-sharded ``embed`` /
``softmax_xent`` / ``greedy_sample``, the sequence-sharded
``flash_decode``, the per-shard MoE dispatch (``moe_local_dispatch``),
``optim.compression`` and ``distributed.gpipe``.  Each slices its
operands by the shard's coordinate, computes each shard's part, reduces
over the named axes through the mesh and finishes each shard.

Single-device knobs: the attention chunks, the logits chunk of the
training loss, ``remat`` ("block": ``forward_train`` recomputes each
repeat of the block pattern, and each tail layer, in the backward pass;
"none": it keeps the layers' activations) and

  attn_remat       recompute each attention q chunk in the backward pass
  attn_probs_bf16  the p @ v product with bf16 probabilities (m and l
                   stay float32)
  ssm_remat        recompute each SSM chunk step in the backward pass
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.distributed import ShardMesh

__all__ = ["ParallelConfig", "shard_shape", "spec_bytes"]


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    mesh: Optional[ShardMesh] = None
    data_axes: Tuple[str, ...] = ("data",)
    # batch_axes defaults to data_axes; set to () for a global batch too
    # small to shard (long-context decode) while keeping fsdp on data_axes
    batch_axes: Optional[Tuple[str, ...]] = None
    model_axis: str = "model"
    seq_shard: bool = True        # sequence-parallel activations
    fsdp: bool = True             # shard weight dim 0 over data axes
    remat: str = "block"          # none | block (training only)
    logits_chunk: int = 2048      # seq chunk for the CE loss
    attn_chunk_q: int = 512
    attn_chunk_k: int = 512
    decode_seq_shard: Tuple[str, ...] = ()  # axes sharding the KV seq dim
    attn_remat: bool = False
    attn_probs_bf16: bool = False
    moe_local_dispatch: bool = False  # each batch shard's own MoE sort
    ssm_remat: bool = False
    decode_kv_head_shard: bool = False  # decode KV specs by KV head
    #                                (layout only: every head's whole
    #                                sequence, no LSE merge)

    def __post_init__(self):
        if self.remat not in ("none", "block"):
            raise ValueError(f"remat={self.remat!r}: 'none' or 'block'")
        if self.mesh is None:
            return
        if not isinstance(self.mesh, ShardMesh):
            raise TypeError(f"ParallelConfig.mesh must be a ShardMesh "
                            f"(launch.mesh.make_debug_mesh), got "
                            f"{type(self.mesh).__name__}")
        if len(set(self.mesh.devices)) != 1:
            raise ValueError(
                f"the mesh spans {sorted({str(d) for d in self.mesh.devices})}"
                f": model tensors are kept whole on one controller's one "
                f"device, so every shard of a model mesh must lie on it")
        names = (self.data_axes + tuple(self.batch_axes or ())
                 + (self.model_axis,) + tuple(self.decode_seq_shard))
        missing = [n for n in names if n not in self.mesh.shape]
        if missing:
            raise ValueError(f"axes {missing} are not in the mesh "
                             f"{self.mesh.shape}")

    # ------------------------------------------------------------------
    @property
    def active(self) -> bool:
        return self.mesh is not None

    def axis_size(self, names: Sequence[str]) -> int:
        return self.mesh.axis_size(tuple(names)) if self.active else 1

    @property
    def n_data(self) -> int:
        return self.axis_size(self.data_axes)

    @property
    def n_model(self) -> int:
        return self.axis_size([self.model_axis])

    # ------------------------------------------------------------------
    def check(self, x, spec, even: bool = False) -> None:
        """Raise ``ValueError`` unless ``spec`` lays out ``x`` (a tensor or
        a shape) on the mesh: no more entries than dims, every name an
        axis of the mesh and none twice; with ``even`` (what a placed
        array needs), each dim a multiple of its axes' size and a tensor
        on the mesh's device."""
        shape = tuple(x.shape) if hasattr(x, "shape") else tuple(x)
        if even and isinstance(x, torch.Tensor) \
                and x.device != self.mesh.devices[0]:
            raise ValueError(f"a tensor on {x.device}, the mesh on "
                             f"{self.mesh.devices[0]}")
        if len(spec) > len(shape):
            raise ValueError(f"spec {spec} has more entries than the "
                             f"{len(shape)} dims of {shape}")
        seen = []
        for dim, entry in zip(shape, spec):
            names = (() if entry is None else (entry,)
                     if isinstance(entry, str) else tuple(entry))
            for n in names:
                if n not in self.mesh.shape or n in seen:
                    raise ValueError(f"spec {spec}: axis {n!r} is not in "
                                     f"the mesh {self.mesh.shape} or is "
                                     f"used twice")
                seen.append(n)
            if even and dim % self.mesh.axis_size(names):
                raise ValueError(f"spec {spec}: dim {dim} of {shape} does "
                                 f"not split over {names}")

    def shard(self, x: torch.Tensor, *spec) -> torch.Tensor:
        """The layout constraint: ``x`` itself, its spec checked where a
        mesh is active."""
        if self.active:
            self.check(x, spec)
        return x

    @property
    def batch_axes_(self) -> Tuple[str, ...]:
        return self.data_axes if self.batch_axes is None else self.batch_axes

    def batch(self):
        """Spec entry for a global-batch dimension."""
        return (self.batch_axes_ or None) if self.active else None

    def seq(self):
        """Spec entry for the sequence dim of inter-block activations."""
        return self.model_axis if (self.active and self.seq_shard) else None

    def fsdp_axis(self):
        return self.data_axes if (self.active and self.fsdp) else None

    def shard_activations(self, h: torch.Tensor) -> torch.Tensor:
        """(B, S, D) inter-block activation layout."""
        return self.shard(h, self.batch(), self.seq(), None)

    # Weight specs -----------------------------------------------------
    def w_col(self, stacked: bool = True):
        """(..., D, F) with F model-parallel (q/k/v/up projections)."""
        base = (self.fsdp_axis(), self.model_axis if self.active else None)
        return ((None,) if stacked else ()) + base

    def w_row(self, stacked: bool = True):
        """(..., F, D) with F model-parallel (out/down projections)."""
        base = (self.model_axis if self.active else None, self.fsdp_axis())
        return ((None,) if stacked else ()) + base

    def w_vocab(self, stacked: bool = False):
        """(V, D) embedding / lm_head: vocab-sharded over the model
        axis."""
        base = (self.model_axis if self.active else None, self.fsdp_axis())
        return ((None,) if stacked else ()) + base

    def w_replicated(self, stacked: bool = True):
        return ((None,) if stacked else ())


def spec_bytes(x) -> int:
    return x.numel() * x.element_size()


def shard_shape(shape, spec, mesh: ShardMesh) -> Tuple[int, ...]:
    """The shape of one shard of an array of ``shape`` laid out by
    ``spec`` on ``mesh`` (``NamedSharding.shard_shape``): each dim
    divided by the size of its entry's axes.  Raises ``ValueError``
    where a dim does not split evenly."""
    shape = tuple(int(d) for d in shape)
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than the "
                         f"{len(shape)} dims of {shape}")
    out = list(shape)
    for i, entry in enumerate(spec):
        names = (() if entry is None else (entry,)
                 if isinstance(entry, str) else tuple(entry))
        n = mesh.axis_size(names)
        if shape[i] % n:
            raise ValueError(f"spec {spec}: dim {shape[i]} of {shape} does "
                             f"not split over {names} ({n} shards)")
        out[i] = shape[i] // n
    return tuple(out)
