"""Model zoo: every layer kind of the ten configs (attention, sliding
window, MoE, Mamba-1/2, the shared block, cross attention, the encoder),
on one device or a single-controller mesh (``ParallelConfig.mesh``)."""
from repro_torch.models.parallel import ParallelConfig
from repro_torch.models.transformer import (Transformer, cache_specs,
                                            decode_step, forward_embed,
                                            forward_train, hidden_states,
                                            init_caches, init_params,
                                            param_specs, prefill)

__all__ = ["ParallelConfig", "Transformer", "cache_specs", "decode_step",
           "forward_embed", "forward_train", "hidden_states", "init_caches",
           "init_params", "param_specs", "prefill"]
