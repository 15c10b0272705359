"""Learning-rate schedules, pure functions of the integer step (port of
``repro/optim/schedule.py``).

The reference computes them in float32 (``jnp`` arithmetic on a step and
Python constants); so does the port, on 0-d CPU tensors, and each returns
the float32 value as a Python float.
"""
from __future__ import annotations

import math

import torch


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def linear_warmup(base_lr: float, warmup_steps: int):
    def lr(step: int) -> float:
        warm = torch.clamp(_f32((step + 1) / max(warmup_steps, 1)), max=1.0)
        return float(base_lr * warm)
    return lr


def cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1):
    def lr(step: int) -> float:
        warm = torch.clamp(_f32((step + 1) / max(warmup_steps, 1)), max=1.0)
        prog = torch.clamp(_f32((step - warmup_steps)
                                / max(total_steps - warmup_steps, 1)),
                           0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(_f32(math.pi) * prog))
        return float(base_lr * warm * cos)
    return lr
