"""Learning-rate schedules (counterpart of ``repro/optim/schedule.py``):
pure functions of the step (an int or an integer tensor) returning a
float32 tensor, in the reference's arithmetic."""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def constant(lr: float):
    return lambda step: _f32(lr)


def linear_warmup(lr: float, warmup_steps: int):
    def f(step):
        frac = torch.clamp(_step(step) / max(warmup_steps, 1), max=1.0)
        return _f32(lr * frac)
    return f


def cosine(lr: float, total_steps: int, warmup_steps: int = 0,
           final_frac: float = 0.1):
    def f(step):
        step = _step(step)
        warm = torch.clamp(step / max(warmup_steps, 1), max=1.0)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return _f32(lr * warm * cos)
    return f


def wsd(lr: float, total_steps: int, warmup_frac: float = 0.01,
        decay_frac: float = 0.1, final_frac: float = 0.01):
    """Warmup-Stable-Decay (MiniCPM, arXiv:2404.06395): linear warmup, long
    stable plateau, fast exponential-ish decay in the last ``decay_frac``."""
    warmup = max(int(total_steps * warmup_frac), 1)
    decay_start = int(total_steps * (1.0 - decay_frac))

    def f(step):
        step = _step(step)
        warm = torch.clamp(step / warmup, max=1.0)
        prog = torch.clamp((step - decay_start)
                           / max(total_steps - decay_start, 1), 0.0, 1.0)
        decay = torch.where(step > decay_start, final_frac ** prog,
                            _f32(1.0))
        return _f32(lr * warm * decay)
    return f


def step_decay(lr: float, boundaries, scales):
    """The paper's VGG schedule: 0.01, then 0.001 from round 50."""
    def f(step):
        step = _step(step)
        out = _f32(lr)
        for b, s in zip(boundaries, scales):
            out = torch.where(step >= b, _f32(lr * s), out)
        return out
    return f
