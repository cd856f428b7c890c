"""LR schedules (the twin of ``repro/train/schedule.py``)."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, base_lr: float, warmup_steps: int, total_steps: int,
                  min_frac: float = 0.1) -> torch.Tensor:
    """Linear warm-up to ``base_lr`` then a cosine to ``min_frac`` of it,
    in float32 on ``step``'s device (a 0-d tensor or a number)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = base_lr * step / max(warmup_steps, 1)
    prog = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = base_lr * (min_frac + (1 - min_frac)
                     * 0.5 * (1.0 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup_steps, warm, cos)
