"""mistral-nemo-12b [dense] — hf:mistralai/Mistral-Nemo-Base-2407.

40L d_model=5120 32H (GQA kv=8, head_dim=128) d_ff=14336 vocab=131072,
128k context (RoPE theta 1e6), full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ATTN, ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=131072, head_dim=128, pattern=(ATTN,), repeats=40,
    mlp_act="silu", rope_theta=1e6, supports_long_context=False,
)
