"""Learning-rate schedules: functions of the step ``t`` (a number or a
tensor) to a float32 0-d tensor; a port of
``repro/optim/schedules.py``."""
from __future__ import annotations

import math

import torch


def _t(t):
    return torch.as_tensor(t, dtype=torch.float32)


def paper_schedule(eta0: float):
    """The paper's local-lr schedule: eta0 / sqrt(t/10 + 1) (Table 6)."""
    def f(t):
        return eta0 / torch.sqrt(_t(t) / 10.0 + 1.0)

    return f


def constant_schedule(eta0: float):
    def f(t):
        return torch.full((), eta0, dtype=torch.float32)

    return f


def cosine_schedule(eta0: float, total_steps: int, warmup: int = 0,
                    floor: float = 0.0):
    """Linear warm-up over ``warmup`` steps, then a cosine from eta0 down
    to ``floor`` at ``total_steps``."""
    def f(t):
        t = _t(t)
        warm = eta0 * torch.clamp(t / max(warmup, 1), 0.0, 1.0)
        frac = torch.clamp((t - warmup) / max(total_steps - warmup, 1),
                           0.0, 1.0)
        cos = floor + (eta0 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(t < warmup, warm, cos)

    return f
