"""Learning-rate schedules (the port of ``repro.optim.schedules``): each
returns a function of the step giving an fp32 scalar tensor."""
from __future__ import annotations

import math

import torch

F32 = torch.float32


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=F32)


def linear_warmup_cosine(peak_lr: float, warmup: int, total: int,
                         final_frac: float = 0.1):
    def fn(step):
        step = torch.as_tensor(step, dtype=F32)
        warm = peak_lr * torch.clamp_max(step / max(warmup, 1), 1.0)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, peak_lr * cos)
    return fn


def inverse_sqrt(peak_lr: float, warmup: int):
    def fn(step):
        step = torch.as_tensor(step, dtype=F32)
        warm = peak_lr * step / max(warmup, 1)
        decay = peak_lr * torch.sqrt(max(warmup, 1)
                                     / torch.clamp_min(step, 1.0))
        return torch.where(step < warmup, warm, decay)
    return fn
