"""Model zoo, its dense decoder-only path (one device)."""
from repro_torch.models.parallel import ParallelConfig
from repro_torch.models.transformer import (Transformer, decode_step,
                                            forward_embed, forward_train,
                                            hidden_states, init_caches,
                                            init_params, prefill)

__all__ = ["ParallelConfig", "Transformer", "decode_step", "forward_embed",
           "forward_train", "hidden_states", "init_caches", "init_params",
           "prefill"]
