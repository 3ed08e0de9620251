"""LR schedules as pure functions of the step counter — the port of
``repro/optim/schedule.py``."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, floor: float = 0.1):
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then a cosine
    decay to ``floor * peak_lr`` at ``total_steps``. ``step`` is a Python
    number (-> a float) or a 0-d tensor (-> an fp32 0-d tensor)."""
    warm_div = max(warmup_steps, 1)
    cos_div = max(total_steps - warmup_steps, 1)
    if isinstance(step, torch.Tensor):
        s = step.float()
        warm = peak_lr * torch.clamp((s + 1) / warm_div, max=1.0)
        frac = torch.clamp((s - warmup_steps) / cos_div, 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(s < warmup_steps, warm, cos)
    s = float(step)
    if s < warmup_steps:
        return peak_lr * min(1.0, (s + 1) / warm_div)
    frac = min(max((s - warmup_steps) / cos_div, 0.0), 1.0)
    return peak_lr * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * frac)))
