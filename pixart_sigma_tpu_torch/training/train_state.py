"""Training state: the model's f32 parameters, the optimizer, an EMA copy, the
step counters and the gradient accumulator. Port of
pixart_sigma_tpu/training/train_state.py, with the semantics of the JAX
trainer's `optax.MultiSteps` wrapper for gradient accumulation. The EMA and
the accumulator of a sharded parameter are held as its local shard, cut
as the parameter is (`parallel.sharded`), as JAX shards them with the
parameters."""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from pixart_sigma_tpu_torch.parallel.sharded import full_state, local, set_grad, take_shard, shard_dims
from pixart_sigma_tpu_torch.training.optim import clip_by_global_norm


def warmup_ema_rate(rate: float, step: int) -> float:
    """Effective EMA rate with warmup: min(rate, (1 + step) / (10 + step))."""
    return min(rate, (1.0 + step) / (10.0 + step))


class TrainState:
    """`step` counts the micro-steps (calls of `apply_gradients`) and
    `opt_step` the optimizer updates; they differ only with
    `accumulation_steps` k > 1, which follows the JAX trainer's
    `optax.MultiSteps(tx, k)` inside its TrainState:

    - the gradients of k micro-steps are averaged as a running mean,
      acc + (g - acc) / (i + 1);
    - the global-norm clip applies to that average, and the optimizer and
      the LR schedule (read at `opt_step`) advance once per k;
    - `step` and the EMA, with its warmup rate read at `step`, advance on
      every micro-step, so k - 1 of k EMA updates move toward unchanged
      parameters.
    """

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 schedule: Callable[[int], float], ema: bool = True, ema_rate: float = 0.9999,
                 ema_warmup: bool = True, accumulation_steps: int = 1):
        self.model = model
        # what a sharded step needs besides (`Trainer` sets them): the module
        # it calls (DDP's wrapper), the parameters whose gradients it
        # averages itself, and the batch ranks' group, count and index
        self.forward = model
        self.sync_params: list = []
        self.batch_group = None
        self.batch_ranks = 1
        self.batch_rank = 0
        self.optimizer = optimizer
        self.schedule = schedule
        self.step = 0
        self.opt_step = 0
        self.ema_rate = ema_rate
        self.ema_warmup = ema_warmup
        self.accumulation_steps = accumulation_steps
        self.ema: Optional[Dict[str, torch.Tensor]] = None
        if ema:
            self.ema = {n: local(p).detach().clone() for n, p in model.named_parameters()}
        self._acc: Optional[Dict[str, torch.Tensor]] = None  # running mean of micro grads

    @property
    def mini_step(self) -> int:
        """The micro-step's index within its accumulation window."""
        return self.step % self.accumulation_steps

    def lr(self) -> float:
        return self.schedule(self.opt_step)

    def _params(self):
        return [(n, p) for n, p in self.model.named_parameters() if p.requires_grad]

    @torch.no_grad()
    def apply_gradients(self, grad_clip: Optional[float] = None,
                        grad_norm: Optional[torch.Tensor] = None,
                        ema_rate: Optional[float] = None) -> None:
        """One micro-step on the model's .grad: accumulate, and on the last
        micro-step of a window clip (by `grad_norm`, the gradients' global
        norm when the caller has it), set the LR and step the optimizer; then
        one EMA update. `ema_rate` overrides the state's rate for this step
        and bypasses the warmup ramp, as in JAX: a prescribed per-step rate
        (LCM's target network tracks the student at 0.95 from step 0)."""
        named = self._params()
        if self.accumulation_steps > 1:
            i = self.mini_step
            if self._acc is None:
                self._acc = {n: torch.zeros_like(local(p), dtype=torch.float32)
                             for n, p in named}
            for n, p in named:
                if p.grad is not None:
                    acc = self._acc[n]
                    acc.add_((local(p.grad).float() - acc) / (i + 1))
            emit = i == self.accumulation_steps - 1
            if emit:
                for n, p in named:
                    set_grad(p, self._acc[n].to(p.dtype))
                self._acc = None
                grad_norm = None  # the average's
        else:
            emit = True
        if emit:
            if grad_clip is not None:
                clip_by_global_norm([p for _, p in named], grad_clip, grad_norm)
            for group in self.optimizer.param_groups:
                group["lr"] = self.lr()
            self.optimizer.step()
            self.opt_step += 1
        if self.ema is not None:
            rate = self.ema_rate if ema_rate is None else ema_rate
            if self.ema_warmup and ema_rate is None:
                rate = warmup_ema_rate(rate, self.step)
            for n, p in self.model.named_parameters():
                self.ema[n].mul_(rate).add_(local(p), alpha=1.0 - rate)
        self.step += 1

    def full_ema(self) -> Dict[str, torch.Tensor]:
        """The EMA as whole tensors on the CPU (a collective when sharded)."""
        return full_state(self.ema.items(), dict(self.model.named_parameters()))

    def load_full_ema(self, weights: Dict[str, torch.Tensor]) -> None:
        """Set the EMA from whole tensors, cut to this rank's shards."""
        params = dict(self.model.named_parameters())
        for n, e in weights.items():
            self.ema[n].copy_(take_shard(e, shard_dims(params[n])))

    def state_dict(self) -> Dict[str, Any]:
        """What a resumed run needs besides the weights, the EMA and the
        optimizer state: the counters and a partly filled accumulator,
        whole (a collective when sharded)."""
        out: Dict[str, Any] = {"step": self.step, "opt_step": self.opt_step}
        if self._acc is not None:
            out["grad_accumulator"] = full_state(self._acc.items(),
                                                 dict(self.model.named_parameters()))
        return out

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.step, self.opt_step = int(state["step"]), int(state["opt_step"])
        acc = state.get("grad_accumulator")
        if acc is not None:
            params = dict(self.model.named_parameters())
            self._acc = {n: take_shard(a, shard_dims(params[n])).to(local(params[n]).device)
                         for n, a in acc.items()}
