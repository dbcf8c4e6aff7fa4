"""Timestep samplers: uniform, and importance sampling by the loss's second
moment.

Port of pixart_sigma_tpu/diffusion/timestep_sampler.py. The resampler's
history ring buffer [T, K] and its fill counts live on the training device
and are updated there, with no read-back. Draws come from the caller's
`torch.Generator` (`torch.multinomial`), so they differ from JAX's
`jax.random.choice` for the same seed; the weights and the update match.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch


def create_named_schedule_sampler(name: str, num_timesteps: int,
                                  device: Union[str, torch.device] = "cpu"):
    if name == "uniform":
        return UniformSampler(num_timesteps)
    if name == "loss-second-moment":
        return LossSecondMomentResampler(num_timesteps, device=device)
    raise NotImplementedError(f"unknown schedule sampler: {name}")


class UniformSampler:
    def __init__(self, num_timesteps: int):
        self.num_timesteps = num_timesteps

    def sample(self, batch: int, generator: Optional[torch.Generator] = None,
               device: Union[str, torch.device] = "cpu") -> Tuple[torch.Tensor, torch.Tensor]:
        t = torch.randint(0, self.num_timesteps, (batch,), generator=generator, device=device)
        return t, torch.ones((batch,), dtype=torch.float32, device=device)


class LossSecondMomentResampler:
    """Sample t with probability proportional to sqrt(E[loss_t^2]) once every
    timestep holds `history_per_term` losses (uniform until then), mixed
    with `uniform_prob` of the uniform; weights 1 / (T p_t) undo the bias."""

    def __init__(self, num_timesteps: int, history_per_term: int = 10,
                 uniform_prob: float = 0.001, device: Union[str, torch.device] = "cpu"):
        self.history_per_term = history_per_term
        self.uniform_prob = uniform_prob
        self.history = torch.zeros((num_timesteps, history_per_term), dtype=torch.float32,
                                   device=device)
        self.counts = torch.zeros((num_timesteps,), dtype=torch.int32, device=device)

    @property
    def num_timesteps(self) -> int:
        return self.history.shape[0]

    def weights(self) -> torch.Tensor:
        """Sampling probabilities per timestep [T]."""
        T = self.num_timesteps
        w = self.history.square().mean(-1).sqrt()
        w = w / torch.clamp(w.sum(), min=1e-12)
        w = w * (1 - self.uniform_prob) + self.uniform_prob / T
        warmed = (self.counts == self.history_per_term).all()
        return torch.where(warmed, w, torch.full_like(w, 1.0 / T))

    def sample(self, batch: int, generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(t [B], loss weights [B]) on the history's device."""
        p = self.weights()
        t = torch.multinomial(p, batch, replacement=True, generator=generator)
        return t, 1.0 / (self.num_timesteps * p[t])

    @torch.no_grad()
    def update(self, t: torch.Tensor, losses: torch.Tensor) -> None:
        """Push each (t, loss) into its timestep's ring, oldest out when full,
        one sample after another in batch order, so a timestep drawn twice in
        a batch takes both losses (as JAX's sequential scan does)."""
        K = self.history_per_term
        t = t.to(self.history.device).long()
        losses = losses.detach().to(self.history.device, torch.float32)
        for i in range(t.shape[0]):
            ti, loss = t[i:i + 1], losses[i:i + 1]
            cnt = self.counts.index_select(0, ti)  # [1]
            row = self.history.index_select(0, ti)[0]  # [K]
            shifted = torch.cat([row[1:], loss])
            written = row.scatter(0, torch.clamp(cnt, max=K - 1).long(), loss)
            self.history.index_put_((ti,), torch.where(cnt == K, shifted, written)[None])
            self.counts.index_put_((ti,), torch.clamp(cnt + 1, max=K))

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return {"history": self.history.clone(), "counts": self.counts.clone()}

    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        self.history.copy_(state["history"])
        self.counts.copy_(state["counts"])
