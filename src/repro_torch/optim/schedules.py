"""Learning-rate schedules: callables of the step count, in fp32 as in the
JAX package's ``repro.optim.schedules``."""
from __future__ import annotations

import math

import torch


def _f32(count) -> torch.Tensor:
    return torch.as_tensor(count, dtype=torch.float32)


def constant(lr: float):
    return lambda count: torch.tensor(lr, dtype=torch.float32)


def cosine(peak: float, total_steps: int, warmup: int = 0,
           floor: float = 0.0):
    def fn(count):
        c = _f32(count)
        warm = peak * c / max(warmup, 1)
        t = ((c - warmup) / max(total_steps - warmup, 1)).clamp(0.0, 1.0)
        cos = floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * t))
        return torch.where(c < warmup, warm, cos)
    return fn


def exponential(init: float, decay: float, every: int):
    def fn(count):
        return torch.tensor(init, dtype=torch.float32) * decay ** (
            _f32(count) / every)
    return fn
