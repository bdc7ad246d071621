"""LR schedules (pure functions of the step counter)."""
from __future__ import annotations

import math

import torch


def warmup_cosine(
    step: torch.Tensor,
    *,
    peak_lr: float,
    warmup_steps: int = 1000,
    total_steps: int = 100_000,
    min_ratio: float = 0.1,
) -> torch.Tensor:
    step = torch.as_tensor(step).float()
    warm = step / max(warmup_steps, 1)
    t = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return peak_lr * torch.where(step < warmup_steps, warm, cos)
