"""LR schedules (port of the reference's optim/schedule.py): functions of
the step counter in fp32, with the reference's arithmetic and order.  A
step given as a tensor keeps its device; an int gives a CPU scalar."""
from __future__ import annotations

import math

import torch


def _step_f32(step):
    return torch.as_tensor(step).to(torch.float32)


def linear_schedule(base_lr: float, warmup: int, total: int):
    def lr(step):
        s = _step_f32(step)
        wu = torch.clamp(s / max(warmup, 1), max=1.0)
        decay = torch.clamp(1.0 - torch.clamp(s - warmup, min=0)
                            / max(total - warmup, 1), min=0.0)
        return base_lr * wu * decay
    return lr


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1):
    def lr(step):
        s = _step_f32(step)
        wu = torch.clamp(s / max(warmup, 1), max=1.0)
        t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
        return base_lr * wu * cos
    return lr
