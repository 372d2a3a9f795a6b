"""LR schedules (pure functions of the step counter).

Counterpart: ``repro/optim/schedules.py``; the arithmetic in fp32, on a
tensor step's device or on the host for an int.
"""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, warmup: int = 100, total: int = 10_000,
                    min_ratio: float = 0.1):
    """Linear warmup -> cosine decay to ``min_ratio``; returns a scale in
    (0, 1] multiplying the base LR (an fp32 0-d tensor)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return warm * cos
