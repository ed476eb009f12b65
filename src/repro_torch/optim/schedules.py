"""Learning-rate schedules: ``step -> lr`` as an f32 scalar tensor.

WSD (warmup-stable-decay) is MiniCPM's [arXiv:2404.06395]; cosine is the
default for everything else.  Each computes in f32 as the JAX package's
does, from an integer or tensor step, on the CPU.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

__all__ = ["constant", "linear_warmup", "cosine", "wsd", "Schedule"]

Schedule = Callable[[object], torch.Tensor]
F32 = torch.float32


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(device="cpu", dtype=F32)


def constant(lr: float) -> Schedule:
    return lambda step: _f32(lr)


def linear_warmup(base: Schedule, warmup_steps: int) -> Schedule:
    def fn(step):
        warm = torch.clamp((_f32(step) + 1) / max(warmup_steps, 1), max=1.0)
        return base(step) * warm

    return fn


def cosine(peak_lr: float, total_steps: int, warmup_steps: int = 0,
           final_frac: float = 0.1) -> Schedule:
    """Linear warmup then cosine decay to ``final_frac * peak_lr``."""

    def fn(step):
        step = _f32(step)
        warm = torch.clamp((step + 1.0) / max(warmup_steps, 1), max=1.0)
        t = torch.clamp((step - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1.0 - final_frac) * 0.5 * (
            1.0 + torch.cos(math.pi * t))
        return _f32(peak_lr) * warm * cos

    return fn


def wsd(peak_lr: float, total_steps: int, warmup_steps: int,
        decay_frac: float = 0.1, final_frac: float = 0.01) -> Schedule:
    """Warmup-Stable-Decay (MiniCPM §4): warmup, a flat plateau, then an
    exponential decay over the last ``decay_frac`` of training down to
    ``final_frac * peak_lr``."""
    decay_steps = max(int(total_steps * decay_frac), 1)
    stable_end = total_steps - decay_steps

    def fn(step):
        step = _f32(step)
        warm = torch.clamp((step + 1.0) / max(warmup_steps, 1), max=1.0)
        t = torch.clamp((step - stable_end) / decay_steps, 0.0, 1.0)
        decay = torch.pow(_f32(final_frac), t)
        return _f32(peak_lr) * warm * decay

    return fn
