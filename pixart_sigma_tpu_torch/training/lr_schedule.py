"""LR schedules as step -> learning-rate functions.

Port of pixart_sigma_tpu/training/lr_schedule.py (constant and cosine with
warmup, cosine decay to a constant). The step is the number of updates made
so far: an update reads the rate at its own count before incrementing it, as
optax does.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

Schedule = Callable[[int], float]


def constant_with_warmup(base_lr: float, num_warmup_steps: int) -> Schedule:
    return lambda step: base_lr * min(1.0, step / max(1, num_warmup_steps))


def cosine_with_warmup(base_lr: float, num_warmup_steps: int, num_training_steps: int,
                       num_cycles: float = 0.5) -> Schedule:
    def schedule(step):
        if step < num_warmup_steps:
            return base_lr * step / max(1, num_warmup_steps)
        progress = (step - num_warmup_steps) / max(1, num_training_steps - num_warmup_steps)
        return base_lr * max(0.0, 0.5 * (1.0 + math.cos(math.pi * num_cycles * 2.0 * progress)))

    return schedule


def cosine_decay_to_constant_with_warmup(
    base_lr: float, num_warmup_steps: int, num_training_steps: int, final_lr: float = 0.0,
    num_decay: float = 0.667, num_cycles: float = 0.5,
) -> Schedule:
    """Cosine anneal to final_lr * base_lr over num_decay of training, then hold."""
    num_decay_steps = int(num_training_steps * num_decay)

    def schedule(step):
        if step < num_warmup_steps:
            return base_lr * step / max(1, num_warmup_steps)
        if step > num_decay_steps:
            return base_lr * final_lr
        progress = (step - num_warmup_steps) / max(1, num_decay_steps - num_warmup_steps)
        cos = max(0.0, 0.5 * (1.0 + math.cos(math.pi * num_cycles * 2.0 * progress)))
        return base_lr * (cos * (1 - final_lr) + final_lr)

    return schedule


def build_lr_schedule(name: str, base_lr: float, *, num_warmup_steps: int = 0,
                      num_training_steps: Optional[int] = None, lr_scale_ratio: float = 1.0,
                      **kwargs) -> Schedule:
    """The config's `lr_schedule` and `lr_schedule_args` as a schedule."""
    if name == "constant":
        return constant_with_warmup(base_lr, num_warmup_steps)
    if name in ("cosine", "cosine_decay_to_constant") and num_training_steps is None:
        raise ValueError(f"the {name} schedule needs num_training_steps")
    if name == "cosine":
        return cosine_with_warmup(base_lr, num_warmup_steps, num_training_steps, **kwargs)
    if name == "cosine_decay_to_constant":
        if lr_scale_ratio < 1:
            raise ValueError(f"lr_scale_ratio {lr_scale_ratio} < 1")
        return cosine_decay_to_constant_with_warmup(
            base_lr, num_warmup_steps, num_training_steps, final_lr=1.0 / lr_scale_ratio,
            **kwargs)
    raise ValueError(f"unrecognized lr schedule {name}")
