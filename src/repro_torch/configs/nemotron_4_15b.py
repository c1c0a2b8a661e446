"""nemotron-4-15b [dense] — arXiv:2402.16819.

32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000,
squared-ReLU MLP; full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ATTN, ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b", family="dense",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=24576,
    vocab=256000, pattern=(ATTN,), repeats=32,
    mlp_act="relu2", rope_theta=1e4, supports_long_context=False,
)
