"""Learning-rate schedules (callables step -> f32 lr tensor)."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    def sched(step):
        return torch.as_tensor(lr, dtype=torch.float32, device=step.device)
    return sched


def cosine_decay(lr: float, decay_steps: int, final_frac: float = 0.0):
    def sched(step):
        t = torch.clamp(step / decay_steps, 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return (lr * (final_frac + (1.0 - final_frac) * cos)).to(torch.float32)
    return sched


def linear_warmup(base, warmup_steps: int):
    """Wrap another schedule (or float) with linear warmup."""
    inner = base if callable(base) else constant(base)

    def sched(step):
        warm = torch.clamp((step + 1) / max(1, warmup_steps), max=1.0)
        return warm * inner(torch.clamp(step - warmup_steps, min=0))
    return sched
