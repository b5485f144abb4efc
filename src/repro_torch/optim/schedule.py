"""LR schedules: linear warmup + cosine decay (port of
src/repro/optim/schedule.py).

The schedule is evaluated as the reference's compiled train step evaluates
it, in f32: XLA rewrites each division by a constant into a product with
its f32 reciprocal, calls the C library's ``cosf`` for the cosine
(`core.xla_math.cos_f32` on CPU tensors) and contracts
``(cos + 1) * 0.45 + 0.1`` into one fused multiply-add.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.xla_math import cos_f32, fma_f32


def warmup_cosine(step, base_lr: float, warmup: int, total: int,
                  final_frac: float = 0.1) -> torch.Tensor:
    """The learning rate at ``step`` (a Python int, or an integer tensor of
    any shape) as an f32 tensor on the step's device (the CPU for an int):
    ``base_lr * min(1, (step + 1) / warmup)`` below ``warmup``, then a
    cosine from ``base_lr`` down to ``final_frac * base_lr`` at ``total``."""
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp_max((s + 1.0) * f32(1.0 / max(1, warmup)), 1.0) * f32(base_lr)
    prog = torch.clamp((s - float(warmup)) * f32(1.0 / max(1, total - warmup)), 0.0, 1.0)
    c = cos_f32(prog * f32(math.pi)) + 1.0
    cos = fma_f32(c, f32((1 - final_frac) * 0.5), f32(final_frac)) * f32(base_lr)
    return torch.where(s < warmup, warm, cos)
