"""Optimizer substrate: AdamW, global-norm clipping, the LR schedule, and
the int8 error-feedback all-reduce over a mesh (``compression``)."""
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.adamw import init as adamw_init
from repro_torch.optim.adamw import update as adamw_update
from repro_torch.optim.clipping import (clip_by_global_norm,
                                       clip_by_global_norm_, global_norm)
from repro_torch.optim.compression import (apply_ef, compressed_psum,
                                          init_ef)
from repro_torch.optim.schedule import warmup_cosine

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "apply_ef",
           "clip_by_global_norm", "clip_by_global_norm_", "compressed_psum",
           "global_norm", "init_ef", "warmup_cosine"]
