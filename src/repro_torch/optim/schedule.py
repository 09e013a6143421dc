"""Learning-rate schedules (port of ``repro/optim/schedule.py``)."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, warmup: int = 200, total: int = 10000,
                    min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup → cosine decay to min_ratio.  Returns a 0-d float32
    scale in (0, 1] multiplying the base lr, on the device of ``step``
    (an int or a 0-d tensor), computed in float32 as the JAX package
    computes it."""
    s = torch.as_tensor(step).to(torch.float32)
    # (s+1)/warmup: the first step trains at lr/warmup instead of zero
    warm = torch.clamp((s + 1.0) / max(warmup, 1), max=1.0)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos
