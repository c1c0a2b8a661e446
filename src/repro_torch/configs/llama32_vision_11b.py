"""llama-3.2-vision-11b [vlm] — hf:meta-llama/Llama-3.2-11B-Vision.

40L text backbone d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256,
cross-attention to image patch embeddings every 5th layer.  The vision
tower is a STUB: input_specs feeds precomputed patch embeddings
(B, 1536, 4096).  Full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ATTN, CROSS, ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=128256, head_dim=128,
    pattern=(ATTN, ATTN, ATTN, ATTN, CROSS), repeats=8,
    num_image_tokens=1536, mlp_act="silu", rope_theta=5e5,
    supports_long_context=False,
)
