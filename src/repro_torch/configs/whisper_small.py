"""whisper-small [audio] — arXiv:2212.04356 (enc-dec backbone only).

12L enc + 12L dec, d_model=768 12H d_ff=3072 vocab=51865 (padded to
51872 for 16-way vocab sharding).  The conv audio frontend is a STUB:
input_specs feeds precomputed frame embeddings (B, 1536, 768).
Enc-dec (has a decoder) -> decode_32k runs; full attention ->
long_500k skipped.
"""
from repro_torch.configs.base import CROSS, ArchConfig

CONFIG = ArchConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
    vocab=51872,  # true 51865, padded for sharding
    pattern=(CROSS,), repeats=12,
    encoder_layers=12, encoder_seq=1536,  # stub frames (paper: 1500)
    mlp_act="silu", rope_theta=1e4, supports_long_context=False,
)
