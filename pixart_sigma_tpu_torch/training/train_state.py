"""Training state: the model's f32 parameters, the optimizer, an EMA copy and
the step counter. Port of pixart_sigma_tpu/training/train_state.py."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn


def warmup_ema_rate(rate: float, step: int) -> float:
    """Effective EMA rate with warmup: min(rate, (1 + step) / (10 + step))."""
    return min(rate, (1.0 + step) / (10.0 + step))


class TrainState:
    """`step` counts the updates made. An update reads the LR schedule and
    the EMA warmup at `step` before incrementing it, as the JAX package's
    optax count and TrainState.step do."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 schedule: Callable[[int], float], ema: bool = True, ema_rate: float = 0.9999,
                 ema_warmup: bool = True):
        self.model = model
        self.optimizer = optimizer
        self.schedule = schedule
        self.step = 0
        self.ema_rate = ema_rate
        self.ema_warmup = ema_warmup
        self.ema: Optional[Dict[str, torch.Tensor]] = None
        if ema:
            self.ema = {n: p.detach().clone() for n, p in model.named_parameters()}

    def lr(self) -> float:
        return self.schedule(self.step)

    @torch.no_grad()
    def apply_gradients(self) -> None:
        """One optimizer step on the model's .grad, then one EMA update."""
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr()
        self.optimizer.step()
        if self.ema is not None:
            rate = self.ema_rate
            if self.ema_warmup:
                rate = warmup_ema_rate(rate, self.step)
            for n, p in self.model.named_parameters():
                self.ema[n].mul_(rate).add_(p, alpha=1.0 - rate)
        self.step += 1
