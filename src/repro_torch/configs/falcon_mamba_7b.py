"""falcon-mamba-7b [ssm] — arXiv:2410.05355 (Mamba-1, attention-free).

64L d_model=4096, ssm_state=16, expand=2 (d_inner 8192), vocab=65024.
d_ff=0: there is no MLP — each layer is one Mamba mixer.
long_500k RUNS (O(1) decode state).
"""
from repro_torch.configs.base import MAMBA1, ArchConfig, SSMSpec

CONFIG = ArchConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=0,
    vocab=65024, pattern=(MAMBA1,), repeats=64,
    ssm=SSMSpec(d_state=16, version=1, expand=2, d_conv=4, chunk=64),
    supports_long_context=True,
)
