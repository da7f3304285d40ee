"""LR schedules: functions of the step (an int or a 0-d tensor) that
return a 0-d f32 tensor, on the step's device."""

from __future__ import annotations

import math

import torch


def _step_f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_with_warmup(peak_lr: float, warmup_steps: int, total_steps: int,
                       min_ratio: float = 0.1):
    def schedule(step):
        s = _step_f32(step)
        warm = peak_lr * s / max(1, warmup_steps)
        prog = ((s - warmup_steps)
                / max(1, total_steps - warmup_steps)).clamp(0.0, 1.0)
        cos = peak_lr * (min_ratio + (1 - min_ratio)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(s < warmup_steps, warm, cos)
    return schedule


def constant(lr: float):
    def schedule(step):
        return torch.full((), lr, dtype=torch.float32,
                          device=torch.as_tensor(step).device)
    return schedule
