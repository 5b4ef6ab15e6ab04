"""LR schedules (pure functions of the step counter)."""
from __future__ import annotations

import math

import torch


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  *, final_frac: float = 0.1):
    def schedule(step):
        step = torch.as_tensor(step).float()
        warm = peak_lr * step / max(warmup_steps, 1)
        progress = torch.clamp(
            (step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0
        )
        cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * progress)))
        return torch.where(step < warmup_steps, warm, cos)

    return schedule
