"""granite-moe-1b-a400m [moe] — hf:ibm-granite/granite-3.0-1b-a400m-base.

24L d_model=1024 16H (GQA kv=8) d_ff=512/expert, 32 experts top-8,
vocab=49155 (padded to 49408 for sharding).
"""
from repro_torch.configs.base import MOE, ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, d_ff=512,
    vocab=49408,  # true 49155, padded for sharding
    pattern=(MOE,), repeats=24,
    moe=MoESpec(num_experts=32, top_k=8, capacity_factor=1.25),
    mlp_act="silu", rope_theta=1e4, supports_long_context=False,
)
