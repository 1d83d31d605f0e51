"""LR schedules (pure functions of the step scalar), as `repro.optim`."""

from __future__ import annotations

import math

import torch


def linear_warmup_cosine(step: torch.Tensor, *, warmup: int, total: int,
                         floor: float = 0.1) -> torch.Tensor:
    """Linear warm-up over `warmup` steps, then a cosine from 1 down to
    `floor` at `total`; f32, on the step's device."""
    step = step.float()
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1.0 - floor) * 0.5 * (1.0 + torch.cos(math.pi * frac))
    return warm * cos


def constant(step, *, value: float = 1.0):
    del step
    return value
