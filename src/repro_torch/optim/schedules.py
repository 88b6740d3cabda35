"""Learning-rate schedules as ``step -> lr`` callables on a 0-d int step
tensor (counterpart of ``repro.optim.schedules``)."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32, device=step.device)


def cosine_decay(lr: float, decay_steps: int, alpha: float = 0.0):
    def sched(step):
        t = torch.clamp_max(step.to(torch.float32), decay_steps) / decay_steps
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return lr * ((1 - alpha) * cos + alpha)

    return sched


def linear_warmup_cosine(lr: float, warmup_steps: int, decay_steps: int, alpha: float = 0.1):
    def sched(step):
        step_f = step.to(torch.float32)
        warm = lr * step_f / max(warmup_steps, 1)
        t = torch.clamp((step_f - warmup_steps) / max(decay_steps - warmup_steps, 1), 0.0, 1.0)
        cos = lr * ((1 - alpha) * 0.5 * (1.0 + torch.cos(math.pi * t)) + alpha)
        return torch.where(step_f < warmup_steps, warm, cos)

    return sched
