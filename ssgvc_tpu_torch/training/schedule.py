"""LR schedule: linear warmup, then cosine decay to min_lr."""

from __future__ import annotations

import math
from typing import Callable

import torch


def warmup_cosine(base_lr: float, min_lr: float, warmup_iters: int,
                  total_iters: int) -> Callable[[int], float]:
    """Returns a schedule step -> lr, computed in fp32 as the JAX
    package's (a float; ``step`` counts applied optimizer updates)."""
    f32 = torch.float32

    def schedule(step) -> float:
        step = torch.tensor(step, dtype=f32)
        warm = base_lr * step / max(warmup_iters, 1)
        decay = (step - warmup_iters) / max(1, total_iters - warmup_iters)
        decay = torch.clamp(decay, 0.0, 1.0)
        coeff = 0.5 * (1.0 + torch.cos(math.pi * decay))
        cos = min_lr + coeff * (base_lr - min_lr)
        if warmup_iters > 0 and step < warmup_iters:
            return float(warm)
        return float(cos)

    return schedule
