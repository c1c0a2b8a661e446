"""LR schedules (warmup + cosine decay), pure functions of the step."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, min_ratio: float = 0.1) -> torch.Tensor:
    """The learning rate at ``step`` (a 0-d tensor, or an int) as a
    float32 0-d tensor on the step's device: no host read."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * step / max(warmup_steps, 1)
    frac = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio)
                     * 0.5 * (1.0 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup_steps, warm, cos)
