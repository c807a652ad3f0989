"""Learning-rate schedules (graspnerf_tpu/train/schedule.py): functions of
the optimizer's update count, as optax calls them."""
from __future__ import annotations

from typing import Callable


def exp_decay_lr(lr_init: float = 1e-4, decay_step: int = 100_000,
                 decay_rate: float = 0.5,
                 lr_min: float = 1e-5) -> Callable[[int], float]:
    """Staircase exponential decay with a floor."""
    def schedule(step: int) -> float:
        return max(lr_init * decay_rate ** (step // decay_step), lr_min)
    return schedule


def warmup_exp_decay_lr(warmup_steps: int = 1000,
                        **kw) -> Callable[[int], float]:
    """A linear warm-up to lr_init over warmup_steps, then exp_decay_lr."""
    base = exp_decay_lr(**kw)
    lr_init = kw.get("lr_init", 1e-4)

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return lr_init * (step + 1) / warmup_steps
        return base(step)
    return schedule
