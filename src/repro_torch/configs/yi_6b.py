"""yi-6b [dense] — arXiv:2403.04652 (llama-arch GQA).

32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
"""
from repro_torch.configs.base import ATTN, ArchConfig

CONFIG = ArchConfig(
    name="yi-6b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4, d_ff=11008,
    vocab=64000, pattern=(ATTN,), repeats=32,
    mlp_act="silu", rope_theta=5e6, supports_long_context=False,
)
