"""Config schema: architectures, input shapes, parallelism.

Every assigned architecture is one ``ArchConfig`` in
``src/repro_torch/configs/<id>.py``; the launchers select them with
``--arch <id>``.  A model is assembled from a *block pattern*: a short
static list of layer descriptors, repeated ``repeats`` times, plus an
optional ``tail`` — which expresses heterogeneous stacks (gemma3's 5
local : 1 global, zamba2's mamba2 + shared-attention).

A copy of ``repro.configs.base`` (plain data, equal field for field);
``param_dtype`` is a ``torch.dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

# Layer kinds usable in a block pattern.
ATTN = "attn"                # global causal self-attention + MLP
SWA = "swa"                  # sliding-window causal self-attention + MLP
MOE = "moe"                  # global attention + MoE MLP
MAMBA1 = "mamba1"            # Mamba-1 selective-scan block
MAMBA2 = "mamba2"            # Mamba-2 (SSD) block
SHARED_ATTN = "shared_attn"  # weight-tied global attention block (zamba2)
CROSS = "cross_attn"         # causal self-attn + cross-attn + MLP (vlm/encdec)


@dataclasses.dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    d_state: int
    version: int = 1           # 1 = Mamba-1, 2 = Mamba-2 (SSD)
    expand: int = 2
    d_conv: int = 4
    head_dim: int = 64         # Mamba-2 only
    dt_rank: int = 0           # 0 -> ceil(d_model / 16) (Mamba-1 default)
    chunk: int = 64            # chunked-scan length


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                # dense | ssm | moe | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    # Block pattern (see module docstring). Must satisfy
    # len(pattern) * repeats + len(tail) == n_layers.
    pattern: Tuple[str, ...] = (ATTN,)
    repeats: int = 0           # 0 -> n_layers // len(pattern)
    tail: Tuple[str, ...] = ()

    head_dim: int = 0          # 0 -> d_model // n_heads
    mlp_act: str = "silu"      # silu (gated) | relu2 (squared ReLU, gated)
    rope_theta: float = 1e6
    sliding_window: int = 1024  # window for SWA layers
    norm_eps: float = 1e-5

    moe: Optional[MoESpec] = None
    ssm: Optional[SSMSpec] = None

    # Modality stubs (precomputed embeddings fed via input_specs).
    encoder_layers: int = 0    # whisper-style bidirectional encoder
    encoder_seq: int = 0       # stub frame/patch sequence length
    num_image_tokens: int = 0  # vlm cross-attention memory length

    supports_long_context: bool = False  # run long_500k?
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # --- derived -----------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_repeats(self) -> int:
        r = self.repeats or (self.n_layers // len(self.pattern))
        assert len(self.pattern) * r + len(self.tail) == self.n_layers, (
            self.name, len(self.pattern), r, len(self.tail), self.n_layers)
        return r

    @property
    def param_dtype(self):
        return getattr(torch, self.dtype)

    def num_params(self) -> int:
        """Analytic parameter count (embeddings + blocks), for 6ND."""
        D, F, V = self.d_model, self.d_ff, self.vocab
        hd, H, Hkv = self.hd, self.n_heads, self.n_kv_heads
        attn = D * H * hd + 2 * D * Hkv * hd + H * hd * D
        mlp = 3 * D * F  # gated
        total = 2 * V * D  # embed + lm_head
        layers = list(self.pattern) * self.n_repeats + list(self.tail)
        for kind in layers:
            if kind in (ATTN, SWA, SHARED_ATTN):
                total += attn + mlp
            elif kind == CROSS:
                total += 2 * attn + mlp
            elif kind == MOE:
                total += attn + self.moe.num_experts * 3 * D * F \
                    + D * self.moe.num_experts
            elif kind in (MAMBA1, MAMBA2):
                di = self.ssm.expand * D
                n = self.ssm.d_state
                if self.ssm.version == 1:
                    dtr = self.ssm.dt_rank or -(-D // 16)
                    total += 2 * D * di + di * (dtr + 2 * n) + dtr * di \
                        + di * n + di * D
                else:
                    nh = di // self.ssm.head_dim
                    total += D * (2 * di + 2 * n + nh) + di * D
        if self.encoder_layers:
            total += self.encoder_layers * (attn + mlp)
        if self.num_image_tokens:
            total += D * D  # image projection stub
        return int(total)

    def num_active_params(self) -> int:
        """Active params per token (MoE: top_k of num_experts)."""
        if self.moe is None:
            return self.num_params()
        total = self.num_params()
        layers = list(self.pattern) * self.n_repeats + list(self.tail)
        n_moe = sum(1 for k in layers if k == MOE)
        dense_share = self.moe.top_k / self.moe.num_experts
        expert_params = n_moe * self.moe.num_experts * 3 * self.d_model * self.d_ff
        return int(total - expert_params * (1.0 - dense_share))


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """(runs?, reason).  long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("pure full-attention arch: no sub-quadratic path for "
                       "a 524288-token context (see DESIGN.md skips)")
    return True, ""
