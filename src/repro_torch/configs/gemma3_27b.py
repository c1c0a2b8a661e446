"""gemma3-27b [dense] — hf:google/gemma-3-* family scaled per assignment.

62L d_model=5376 32H (GQA kv=16, head_dim=128) d_ff=21504 vocab=262144,
5 local (sliding window 1024) : 1 global pattern, 128k context.
long_500k RUNS: 52/62 layers are windowed (ring caches); the 10 global
layers decode with a seq-sharded flash-decode.
"""
from repro_torch.configs.base import ATTN, SWA, ArchConfig

CONFIG = ArchConfig(
    name="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, d_ff=21504,
    vocab=262144, head_dim=128,
    pattern=(SWA, SWA, SWA, SWA, SWA, ATTN), repeats=10, tail=(SWA, SWA),
    sliding_window=1024, mlp_act="silu", rope_theta=1e6,
    supports_long_context=True,
)
