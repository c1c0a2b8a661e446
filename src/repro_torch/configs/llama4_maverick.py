"""llama4-maverick-400b-a17b [moe] — hf:meta-llama/Llama-4 family.

48L d_model=5120 40H (GQA kv=8) d_ff=8192/expert, 128 experts top-1,
vocab=202048.  All-MoE layers per assignment; full attention ->
long_500k skipped.
"""
from repro_torch.configs.base import MOE, ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
    vocab=202048, head_dim=128, pattern=(MOE,), repeats=48,
    moe=MoESpec(num_experts=128, top_k=1, capacity_factor=1.25),
    mlp_act="silu", rope_theta=5e5, supports_long_context=False,
)
