"""zamba2-1.2b [hybrid] — arXiv:2411.15242.

38 blocks d_model=2048: Mamba-2 (ssm_state=64) backbone with a SHARED
(weight-tied) full-attention block every 6th position.
32H kv=32, d_ff=8192 (shared block MLP), vocab=32000.
long_500k RUNS (SSM state O(1); shared-attn KV seq-sharded).
"""
from repro_torch.configs.base import MAMBA2, SHARED_ATTN, ArchConfig, SSMSpec

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab=32000,
    pattern=(MAMBA2, MAMBA2, MAMBA2, MAMBA2, MAMBA2, SHARED_ATTN),
    repeats=6, tail=(MAMBA2, MAMBA2),
    ssm=SSMSpec(d_state=64, version=2, expand=2, d_conv=4, head_dim=64,
                chunk=64),
    mlp_act="silu", rope_theta=1e4, supports_long_context=True,
)
