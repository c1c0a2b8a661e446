"""Optimizer substrate: AdamW, global-norm clipping, the LR schedule.

The int8 error-feedback compression (``repro.optim.compression``) needs
the mesh and comes with model parallelism (Slice F3)."""
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.adamw import init as adamw_init
from repro_torch.optim.adamw import update as adamw_update
from repro_torch.optim.clipping import (clip_by_global_norm,
                                       clip_by_global_norm_, global_norm)
from repro_torch.optim.schedule import warmup_cosine

__all__ = ["AdamWConfig", "adamw_init", "adamw_update",
           "clip_by_global_norm", "clip_by_global_norm_", "global_norm",
           "warmup_cosine"]
